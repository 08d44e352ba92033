"""Embed traffic: callers of ``ColXLIPService.embed`` in closed loops.

Set-up builds the service (batcher threads, the bucketed engine) on the
program's model holding the benchmark's weights, makes the payload pools
(seeded images in the transform's output form, [H, W, 3] float32, and
seeded token rows) and warms every bucket of both towers. In the window
each client sends a request, waits for its result, copies the pooled
embeddings to the host (and the token features where its caller keeps
them), and sends the next, until the window's seconds are up; requests in
flight then finish. A request is timed from its submit until its results
are on the host; the tail of those times is a per-layer reading.

The workload's ``callers`` say who sends what: each group has ``clients``
clients of one ``kind`` (image or text), ``items`` [min, max] a request and
``tokens`` (whether it copies the token features). Every seed gives each
client the same multiset of request sizes, ``plan_requests`` of them laid
out evenly over its range, in an order of its own; which pool rows a
request carries (a run of consecutive rows, handed over as a view, so that
the clients copy nothing the service would not) and its order are drawn
from the seed. Every ``keep_every``-th request of a client, from an offset
drawn from the seed, is kept, and of those at most ``keep_max`` a caller,
drawn from the seed, are compared with the reference once the window has
closed.

Faults (tests and limit readings only): ``altered`` changes one element of
the first row of every wave where the engine produces it; ``half_batch``
encodes the first half of each wave's rows and repeats them for the rest.
``control`` puts the reference, its products in float8 (``reference.fp8``),
in the program's place: the compared requests' results are replaced by its
own before they are compared.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import core
from ..weights import caption_lengths, make_images, make_state, make_texts
from .train import MISSING_ROW_GAP, Window, input_seed

ALTERED_BY = 0.25
FAULTS = (None, "control", "altered", "half_batch")


@dataclasses.dataclass
class Request:
    kind: str
    rows: np.ndarray
    tokens: bool
    caller: int


@dataclasses.dataclass
class Done:
    start: float
    end: float
    items: int
    ok: bool


def request_sizes(lo: int, hi: int, n: int) -> List[int]:
    """``n`` item counts covering [lo, hi] evenly: the same multiset for
    every seed."""
    return [lo + (j * (hi - lo + 1)) // n for j in range(n)]


def client_plans(cell: core.Cell) -> List[List[Request]]:
    p = cell.params
    plans = []
    for g, caller in enumerate(p["callers"]):
        sizes = request_sizes(*caller["items"], p["plan_requests"])
        pool = p[f"{caller['kind']}_pool"]
        if max(sizes) > pool:
            raise ValueError(f"a request of {max(sizes)} items exceeds a payload pool")
        for _ in range(caller["clients"]):
            rng = np.random.default_rng([cell.seed, len(plans)])
            plan = []
            for o in rng.permutation(len(sizes)):
                start = int(rng.integers(0, pool - sizes[o] + 1))
                plan.append(Request(caller["kind"], np.arange(start, start + sizes[o]),
                                    caller["tokens"], g))
            plans.append(plan)
    return plans


def make_pools(cell: core.Cell, device):
    """(images [N, H, W, 3] float32, texts [N, ctx] int32), made on the
    device from the seed and held on the host, as decoded requests are."""
    g, p = cell.geometry, cell.params
    gen = torch.Generator(device=device).manual_seed(input_seed(cell.seed))
    images = make_images(p["image_pool"], g, gen, device)
    texts = make_texts(p["text_pool"], g, gen, device,
                       caption_lengths(p["caption_tokens"])).int()
    return images, texts


class Kind:
    def __init__(self, cell: core.Cell, device, fault: Optional[str] = None):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.device, self.fault = cell, torch.device(device), fault
        self.control = fault == "control"
        self.prog: Dict[str, object] = {}
        self.stages = core.Stages()

    def setup(self) -> None:
        from colxlip_tpu_torch.serving.server import ColXLIPService

        p, g = self.cell.params, self.cell.geometry
        model, cfg = core.build_program_model(self.cell, self.device, train=False)
        self.stages.mark("model")
        service = ColXLIPService(self.cell.config["model_name"], device=self.device,
                                 dtype=getattr(torch, self.cell.config["dtype"]),
                                 max_batch=p["max_batch"], max_wait_ms=p["max_wait_ms"],
                                 model=model, cfg=cfg)
        self._plant(service.engine)
        self.stages.mark("service")
        images, texts = make_pools(self.cell, self.device)
        self.pools = {"image": images.cpu().numpy(), "text": texts.cpu().numpy()}
        del images, texts
        self.stages.mark("pools")
        service.engine.warmup({"text": (g.t_ctx,), "image": (g.image_size, g.image_size, 3)})
        self._sync()
        self.stages.mark("warm-up")
        self.prog = {"service": service, "model": model}
        self.plans = client_plans(self.cell)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def _plant(self, engine) -> None:
        run = engine.run
        if self.fault == "altered":
            def altered(kind, batch):
                out = [o.clone() for o in run(kind, batch)]
                out[0][0, 0] += ALTERED_BY
                return tuple(out)
            engine.run = altered
        elif self.fault == "half_batch":
            def half(kind, batch):
                n = batch.shape[0]
                out = run(kind, batch[:(n + 1) // 2])
                return tuple(torch.cat([o, o])[:n] for o in out)
            engine.run = half

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, tracer) -> Window:
        p, service = self.cell.params, self.prog["service"]
        seconds = min(self.cell.seconds, p["trace_seconds"]) if tracer.enabled \
            else self.cell.seconds
        done: List[List[Done]] = [[] for _ in self.plans]
        kept: List[list] = [[] for _ in self.plans]
        offsets = np.random.default_rng([self.cell.seed, len(self.plans)]).integers(
            0, p["keep_every"], len(self.plans))
        start = threading.Barrier(len(self.plans) + 1)
        stats0 = self._batcher_stats()
        state = {"t0": 0.0}

        def client(c: int) -> None:
            plan, pools = self.plans[c], self.pools
            start.wait()
            j = 0
            while time.perf_counter() < state["t0"] + seconds:
                req = plan[j % len(plan)]
                payload = pools[req.kind][req.rows[0]:req.rows[-1] + 1]
                t = time.perf_counter()
                try:
                    with tracer.span("portbench.embed"):
                        out = service.embed(req.kind, payload)
                    with tracer.span("portbench.copy"):
                        host = [out[0].cpu()] + ([out[1].cpu()] if req.tokens else [])
                    ok = True
                except Exception:   # noqa: BLE001 - a failed request counts as failed
                    ok, host = False, None
                done[c].append(Done(t, time.perf_counter(), len(req.rows), ok))
                if j % p["keep_every"] == offsets[c]:
                    kept[c].append((req, host))
                j += 1

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(len(self.plans))]
        for t in threads:
            t.start()
        tracer.start()
        with tracer.span("portbench.window"):
            state["t0"] = time.perf_counter()
            start.wait()
            for t in threads:
                t.join()
            self._sync()
        view = tracer.stop()
        t0, t1 = state["t0"], state["t0"] + seconds
        stats1 = self._batcher_stats()
        reqs = [d for per in done for d in per]
        lat = np.array([d.end - d.start for d in reqs if d.ok]) * 1e3
        items = sum(d.items for d in reqs if d.ok and d.end <= t1)
        self.kept = self._sample([k for per in kept for k in per])
        waves = stats1["waves"] - stats0["waves"]
        return Window(
            e2e={"embed_items_s": items / (t1 - t0)},
            attempted=len(reqs), failed=sum(not d.ok for d in reqs),
            units={"waves": waves, "wave_items": stats1["items"] - stats0["items"],
                   "requests": len(reqs),
                   "p95_ms": float(np.percentile(lat, 95)) if len(lat) else None},
            counters={}, trace=view)

    def _sample(self, kept: list) -> list:
        """At most ``keep_max`` kept requests of each caller, drawn from the seed."""
        rng = np.random.default_rng([self.cell.seed, len(self.plans) + 1])
        out = []
        for g in range(len(self.cell.params["callers"])):
            mine = [k for k in kept if k[0].caller == g]
            pick = rng.permutation(len(mine))[:self.cell.params["keep_max"]]
            out += [mine[i] for i in sorted(pick)]
        return out

    def _batcher_stats(self) -> Dict[str, int]:
        stats = [b.stats for b in self.prog["service"]._batchers.values()]
        return {k: sum(s[k] for s in stats) for k in ("waves", "items", "failures")}

    def release(self) -> None:
        service = self.prog.get("service")
        if service is not None:
            service.stop()
        self.prog.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> Dict[str, float]:
        """The reference's towers in fp32 over every kept request's rows, and
        the widest gap of a served unit vector from the reference's; a kept
        request that failed, or a window that kept none, reads
        ``MISSING_ROW_GAP``."""
        ref = core.load_reference(self.cell)
        ref.exact_fp32()
        g, block = self.cell.geometry, self.cell.params["ref_block"]
        params = make_state(g, self.cell.seed, self.device)
        images, texts = make_pools(self.cell, self.device)
        pools = {"image": images, "text": texts.long()}
        if not self.kept:
            return {"pooled_gap": MISSING_ROW_GAP, "token_gap": MISSING_ROW_GAP}
        gaps = {"pooled_gap": 0.0, "token_gap": 0.0}
        for kind in ("image", "text"):
            reqs = [(r, h) for r, h in self.kept if r.kind == kind]
            if not reqs:
                continue
            rows = torch.from_numpy(np.concatenate([r.rows for r, _ in reqs])).to(self.device)
            pooled, tokens = ref.encode_reference(params, g, kind, pools[kind][rows], block)
            if self.control:
                low = ref.encode_reference(params, g, kind, pools[kind][rows], block, ref.fp8)
            i = 0
            for r, host in reqs:
                n = len(r.rows)
                if self.control:
                    host = [o[i:i + n] for o in low]
                if host is None:
                    gaps = {k: MISSING_ROW_GAP for k in gaps}
                    i += n
                    continue
                d = host[0].to(self.device).float() - pooled[i:i + n]
                gaps["pooled_gap"] = max(gaps["pooled_gap"], float(d.norm(dim=-1).max()))
                if r.tokens:
                    d = host[1].to(self.device).float() - tokens[i:i + n]
                    gaps["token_gap"] = max(gaps["token_gap"], float(d.norm(dim=-1).max()))
                i += n
        return gaps

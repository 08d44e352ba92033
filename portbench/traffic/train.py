"""Train traffic: the program's colclip train step on a pool of seeded
batches resident on the card.

Set-up builds one step object (model, AdamW, cosine schedule) on the
benchmark's weights, drives it through its first three steps on pool
batches 0, 1 and 2 (rows that all differ) and reads what the reference will
be held to: each step's losses, the four feature tensors the first step's
forward produced, the first gradient as AdamW holds it after one step
(``exp_avg / (1 - beta1)``), and each parameter's change after the three
(kept on the host until the reference has run). More warm steps
follow, then the window runs the same object on, cycling the pool, and ends
in ``torch.cuda.synchronize()``.

The change is compared over the elements whose first reference gradient is
at least ``MOVED_SHARE`` of the median leaf's root-mean-square gradient: an
element the loss does not reach (the key bias under the softmax, a third of
every packed ``in_proj_bias``) moves under AdamW by its round-off alone.

Params (the workload file): ``batch``, ``pool``, ``caption_tokens`` [min,
max] (EOT included), ``warm_steps`` (the three read steps among them),
``trace_steps``, ``ref_block`` (rows a reference block), ``alpha``,
``mask_mode``, and the optimizer's ``lr``, ``warmup``, ``total_steps``,
``beta1``, ``beta2``, ``eps``, ``wd``.

The decay is compared apart: AdamW's decoupled weight decay moves each
element by under 1% of the step at the warmup's rates, at right angles to
it, so a norm of the change cannot see it. ``decay_gap`` is the gap of the
program's sum over every leaf of (change . start) from the reference's,
over the reference's: the decay pulls each decayed leaf along itself.

Faults (tests and limit readings only): ``half_batch`` feeds the step's
forward the first half of each batch, so the mean is over the rest;
``frozen`` makes every update a no-op, so the step returns its state
unchanged; ``no_decay`` drops the weight decay; ``decay_all`` decays every
leaf, gains and biases too. ``control`` puts the reference, its products in
float8 (``reference.fp8``), in the program's place for the three read
steps; it has no window.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Dict, List, Optional

import torch

from .. import core
from ..weights import caption_lengths, make_images, make_state, make_texts

LOSS_KEYS = ("global_contrastive_loss", "token_contrastive_loss", "total_loss")
FEATURE_KEYS = ("image_features", "token_image_features", "text_features",
                "token_text_features")
MISSING_ROW_GAP = 2.0       # the widest gap of two unit vectors
READ_STEPS = 3
INPUT_SEED_OFFSET = 0x9E3779B97F4A7C15
MOVED_SHARE = 1e-3
FAULTS = (None, "control", "half_batch", "frozen", "no_decay", "decay_all")


@dataclasses.dataclass
class Window:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    units: Dict[str, float]          # what the readers divide by: steps
    counters: Dict[str, int]
    trace: Optional[object] = None


def input_seed(seed: int) -> int:
    return (seed + INPUT_SEED_OFFSET) % (1 << 63)


def make_pool(cell: core.Cell, device, batches: int):
    """The first ``batches`` of the cell's pool: (images, texts) each."""
    g, p = cell.geometry, cell.params
    lengths = caption_lengths(p["caption_tokens"])
    gen = torch.Generator(device=device).manual_seed(input_seed(cell.seed))
    pool = []
    for _ in range(batches):
        images = make_images(p["batch"], g, gen, device)
        texts = make_texts(p["batch"], g, gen, device, lengths)
        pool.append((images, texts))
    return pool


def launch_counters() -> Dict[str, int]:
    from colxlip_tpu_torch.ops import attention, fused_ln, fused_mlp, maxsim
    return {"attention_fwd": attention.LAUNCHES.value,
            "attention_bwd": attention.BWD_LAUNCHES.value,
            "maxsim_fwd": maxsim.LAUNCHES.value, "maxsim_bwd": maxsim.BWD_LAUNCHES.value,
            "layernorm_fwd": fused_ln.FWD_LAUNCHES.value,
            "layernorm_bwd": fused_ln.BWD_LAUNCHES.value,
            "mlp_fwd": fused_mlp.FWD_LAUNCHES.value, "mlp_bwd": fused_mlp.BWD_LAUNCHES.value}


def leaf_gaps(prog: List[float], want: List[float]) -> List[float]:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of its reference norm
    and the median leaf's."""
    median = statistics.median(want)
    return [abs(a - b) / max(b, median) for a, b in zip(prog, want)]


def widest_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """The widest Euclidean gap between a row of ``prog`` and the same row of
    ``want`` (unit vectors along the last axis); a row the program did not
    produce counts as ``MISSING_ROW_GAP``."""
    n = min(prog.shape[0], want.shape[0])
    gap = float((prog[:n].to(want.device) - want[:n]).norm(dim=-1).max())
    return gap if n == want.shape[0] else max(gap, MISSING_ROW_GAP)


class Kind:
    def __init__(self, cell: core.Cell, device, fault: Optional[str] = None):
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cell, self.device, self.fault = cell, torch.device(device), fault
        self.control = fault == "control"
        self.prog: Dict[str, object] = {}
        self.stages = core.Stages()

    # -- the program ------------------------------------------------------------
    def setup(self) -> None:
        if self.control:
            return self._setup_control()
        from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
        from colxlip_tpu_torch.training.optim import create_optimizer
        from colxlip_tpu_torch.training.schedules import cosine_lr

        p = self.cell.params
        model, _ = core.build_program_model(self.cell, self.device, train=True)
        self.stages.mark("model")
        schedule = cosine_lr(p["lr"], p["warmup"], p["total_steps"])
        optimizer = create_optimizer(model, schedule, beta1=p["beta1"], beta2=p["beta2"],
                                     eps=p["eps"], weight_decay=p["wd"])
        step = make_train_step(model, optimizer, schedule, TrainStepConfig(
            loss_type="colclip", alpha=p["alpha"], mask_mode=p["mask_mode"]))
        self._plant(step, optimizer)
        self.pool = make_pool(self.cell, self.device, p["pool"])
        self.stages.mark("step and pool")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.names = [n for n, _ in model.named_parameters()]
        losses, features = [], {}
        forward = step.forward

        def first_forward(images, texts):
            out = forward(images, texts)
            features.update({k: out[k].detach().float().cpu() for k in FEATURE_KEYS})
            return out

        for i in range(READ_STEPS):
            step.forward = first_forward if i == 0 else forward
            metrics = step(*self.pool[i])
            losses.append([float(metrics[k]) for k in LOSS_KEYS])
            if i == 0:
                first = self._first_gradient_norms(model, optimizer)
            self.stages.mark(f"step {i + 1}")
        self.read = {"losses": losses, "features": features, "grad": first,
                     "change": self._changes(model)}
        self.stages.mark("changes")
        for i in range(READ_STEPS, p["warm_steps"]):
            step(*self.pool[i % len(self.pool)])
        self._sync()
        self.stages.mark("warm steps")
        self.prog = {"model": model, "optimizer": optimizer, "step": step}
        self.next_batch = p["warm_steps"]

    def _hyper(self) -> dict:
        p = self.cell.params
        return {k: p[k] for k in ("alpha", "lr", "warmup", "total_steps", "beta1", "beta2",
                                  "eps", "wd")}

    def _setup_control(self) -> None:
        """The read steps of the reference in float8, as the program's."""
        ref = core.load_reference(self.cell)
        ref.exact_fp32()
        g = self.cell.geometry
        params = make_state(g, self.cell.seed, self.device)
        self.names = list(params)
        low = ref.TrainReference(g, params, self._hyper(), self.cell.params["ref_block"],
                                 q=ref.fp8)
        losses = []
        for i, batch in enumerate(make_pool(self.cell, self.device, READ_STEPS)):
            step_losses, grads = low.step(*batch)
            losses.append([step_losses[k] for k in LOSS_KEYS])
            if i == 0:
                first = ref.leaf_norms(grads, self.names)
                features = {k: f.cpu() for k, f in zip(FEATURE_KEYS, low.features)}
            del grads
        with torch.no_grad():
            change = {k: (low.p[k] - params[k]).cpu() for k in self.names}
        self.read = {"losses": losses, "features": features, "grad": first, "change": change}
        self.stages.mark("control steps")

    def _plant(self, step, optimizer) -> None:
        if self.fault == "half_batch":
            forward = step.forward
            step.forward = lambda im, tx: forward(im[:im.shape[0] // 2], tx[:tx.shape[0] // 2])
        elif self.fault == "frozen":
            optimizer.step = lambda closure=None: None
            step.cfg = dataclasses.replace(step.cfg, clamp_logit_scale=False)
        elif self.fault in ("no_decay", "decay_all"):
            wd = 0.0 if self.fault == "no_decay" else self.cell.params["wd"]
            for group in optimizer.param_groups:
                group["weight_decay"] = wd

    def _first_gradient_norms(self, model, optimizer) -> List[float]:
        beta1 = self.cell.params["beta1"]
        norms = []
        for p in model.parameters():
            state = optimizer.state.get(p, {})
            m = state.get("exp_avg")
            norms.append(m.float().norm() / (1 - beta1) if m is not None
                         else torch.zeros((), device=p.device))
        return torch.stack(norms).tolist()

    @torch.no_grad()
    def _changes(self, model) -> Dict[str, torch.Tensor]:
        """Each parameter's change since the start, on the host."""
        p0 = make_state(self.cell.geometry, self.cell.seed, self.device)
        return {n: (p.float() - p0[n]).cpu() for n, p in model.named_parameters()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, tracer) -> Window:
        p = self.cell.params
        batch = p["batch"]
        if self.control:     # the reference's read steps stand in; nothing is timed
            return Window(e2e={"train_img_s": 0.0, "train_peak_gib": 0.0}, attempted=0,
                          failed=0, units={"steps": 0, "batch": batch}, counters={})
        step, pool = self.prog["step"], self.pool
        nonfinite = torch.zeros((), dtype=torch.int32, device=self.device)
        before = launch_counters()
        tracer.start()
        steps, i = 0, self.next_batch
        t0 = time.perf_counter()
        with tracer.span("portbench.window"):
            while True:
                with tracer.span("portbench.step"):
                    metrics = step(*pool[i % len(pool)])
                nonfinite += (~torch.isfinite(metrics["total_loss"])).int()
                steps, i = steps + 1, i + 1
                if (steps >= p["trace_steps"] if tracer.enabled
                        else time.perf_counter() - t0 >= self.cell.seconds):
                    break
            self._sync()
        seconds = time.perf_counter() - t0
        view = tracer.stop()
        after = launch_counters()
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else 0
        return Window(e2e={"train_img_s": steps * batch / seconds,
                           "train_peak_gib": peak / 2 ** 30},
                      attempted=steps, failed=int(nonfinite),
                      units={"steps": steps, "batch": batch},
                      counters={k: after[k] - before[k] for k in after}, trace=view)

    def release(self) -> None:
        self.prog.clear()
        self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------------------
    def readings(self) -> Dict[str, float]:
        """The reference's first three steps on the same weights and batches,
        and the gaps of the program's readings from them."""
        ref = core.load_reference(self.cell)
        ref.exact_fp32()
        g, p = self.cell.geometry, self.cell.params
        params = make_state(g, self.cell.seed, self.device)
        reference = ref.TrainReference(g, params, self._hyper(), p["ref_block"])
        batches = make_pool(self.cell, self.device, READ_STEPS)
        ref_losses = []
        for i, (images, texts) in enumerate(batches):
            losses, grads = reference.step(images, texts)
            ref_losses.append([losses[k] for k in LOSS_KEYS])
            if i == 0:
                feature_gap = max(widest_gap(self.read["features"][k], f)
                                  for k, f in zip(FEATURE_KEYS, reference.features))
                ref_grad = ref.leaf_norms(grads, self.names)
                rms = statistics.median(n / grads[k].numel() ** 0.5
                                        for n, k in zip(ref_grad, self.names))
                moved = {k: grads[k].abs() >= MOVED_SHARE * rms for k in self.names}
            del grads
        with torch.no_grad():
            kept = [k for k in self.names if bool(moved[k].any())]
            prog_change = torch.stack([self.read["change"][k].to(self.device)[moved[k]].norm()
                                       for k in kept]).tolist()
            ref_change = torch.stack([(reference.p[k] - params[k])[moved[k]].norm()
                                      for k in kept]).tolist()
            along = [sum(float((change(k) * params[k]).sum(dtype=torch.float64))
                         for k in self.names)
                     for change in (lambda k: self.read["change"][k].to(self.device),
                                    lambda k: reference.p[k] - params[k])]
        return {"loss_gap": max(abs(a - b) for pl, rl in zip(self.read["losses"], ref_losses)
                                for a, b in zip(pl, rl)),
                "feature_gap": feature_gap,
                "grad_norm_gap": max(leaf_gaps(self.read["grad"], ref_grad)),
                "change_norm_gap": max(leaf_gaps(prog_change, ref_change)),
                "decay_gap": abs(along[0] - along[1]) / abs(along[1])}

"""One rank of the port's data-parallel tests on the CPU (gloo).

    python tests/torch_dist_worker.py <suite> <rank> <world> <port> <inputs> <out_dir> [argv...]

Every rank of a suite runs every case of it on its own rows of the same
seeded inputs and writes ``<out_dir>/rank<r>.npz``; the test files
(``tests/test_torch_dist*.py``) spawn the ranks once per file and hold
the results against the JAX ``shard_map`` functions. Suites:

- ``losses``: the ``LOSS_CASES`` of ``LOSS_SUITES['losses']`` (the
  collectives, clip and colclip);
- ``siglip``: the ``LOSS_CASES`` of ``LOSS_SUITES['siglip']`` (SigLIP's four
  negative exchanges and the distillation loss);
- ``step``: ``STEP_CASES``, one train step each from the same weights;
- ``main``: ``colxlip_tpu_torch.main.main(argv)``; the rank saves its
  final parameters (its shards and their placements under sharded state), and with ``--stop-after-step k`` (before ``argv``)
  signals itself SIGUSR1 after its k-th step.
- ``gspmd``: ``GSPMD_CASES``, one sharded step each (``parallel/gspmd.py``)
  from the same weights on the data rows of this rank's data index, then
  the sharded saves of the last case's state and the save contracts of
  ``tests/test_sharded_ckpt.py`` on a 4-rank data mesh.
- ``gspmd_coca``: ``coca-S-test`` under the tensor-parallel plan
  (``--model-parallel 2``; FSDP too at 4 ranks): one coca step's metrics and
  whole gradients, the parameters after it and their sharded save; then
  ``COLXLIP_MLP_INT8=fwd``: an ``MLP`` at P = 2 against the same module at
  P = 1 (forward and gradients; the per-shard-scale split beside it) and one
  colclip step of ``ViT-S-16-test-colxlip`` under the plan.

This file imports nothing of the JAX package: the ranks run the port alone.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# name -> (kind, keywords); kinds: 'gather', 'shift', 'clip', 'colclip',
# 'siglip' ('bias' adds a logit_bias), 'distill'
LOSS_CASES = {
    "gather_with_grad": ("gather", dict(gather_with_grad=True)),
    "gather_no_grad": ("gather", dict()),
    "gather_local_loss": ("gather", dict(local_loss=True)),
    "ring_shift_plus_1": ("shift", dict(shift=1)),
    "ring_shift_minus_1": ("shift", dict(shift=-1)),
    "clip_full": ("clip", dict()),
    "clip_full_gather_with_grad": ("clip", dict(gather_with_grad=True)),
    "clip_local": ("clip", dict(local_loss=True)),
    "clip_local_gather_with_grad": ("clip", dict(local_loss=True, gather_with_grad=True)),
    "clip_fused_local": ("clip", dict(local_loss=True, ce_impl="fused")),
    "clip_fused_full": ("clip", dict(ce_impl="fused")),
    "colclip_full": ("colclip", dict()),
    "colclip_full_gather_with_grad": ("colclip", dict(gather_with_grad=True)),
    "colclip_full_valid": ("colclip", dict(mask_mode="valid")),
    "colclip_local_gather": ("colclip", dict(local_loss=True)),
    "colclip_local_gather_valid": ("colclip", dict(local_loss=True, mask_mode="valid")),
    "colclip_ring": ("colclip", dict(local_loss=True, token_dist="ring", gather_with_grad=True)),
    "colclip_ring_cap2": ("colclip", dict(local_loss=True, token_dist="ring",
                                          token_neighborhood=2, gather_with_grad=True)),
    "colclip_ring_valid": ("colclip", dict(local_loss=True, token_dist="ring",
                                           mask_mode="valid", gather_with_grad=True)),
    "colclip_ring_no_grad": ("colclip", dict(local_loss=True, token_dist="ring")),
    "colclip_ring_cap2_no_grad": ("colclip", dict(local_loss=True, token_dist="ring",
                                                  token_neighborhood=2)),
    "siglip_bidir": ("siglip", dict(dist_impl="bidir")),
    "siglip_shift": ("siglip", dict(dist_impl="shift")),
    "siglip_reduce": ("siglip", dict(dist_impl="reduce")),
    "siglip_gather": ("siglip", dict(dist_impl="gather")),
    "siglip_bidir_bias": ("siglip", dict(dist_impl="bidir", bias=True)),
    "siglip_reduce_bias": ("siglip", dict(dist_impl="reduce", bias=True)),
    "distill_full": ("distill", dict()),
    "distill_full_gather_with_grad": ("distill", dict(gather_with_grad=True)),
    "distill_local": ("distill", dict(local_loss=True)),
    "distill_local_gather_with_grad": ("distill", dict(local_loss=True,
                                                       gather_with_grad=True)),
}
LOSS_SUITES = {"losses": ("gather", "shift", "clip", "colclip"), "siglip": ("siglip", "distill")}
LOSS_SCALE = 10.0
LOSS_BIAS = -2.0
LOSS_ALPHA = 0.6

# name -> TrainStepConfig keywords (the colclip loss); 'text_ctx' feeds
# texts shorter than the model's context
STEP_CASES = {
    "gather_with_grad": dict(gather_with_grad=True),
    "no_gather_grad": dict(),
    "accum_freq_2": dict(accum_freq=2),
    "local_ring_cap2": dict(local_loss=True, token_dist="ring", token_neighborhood=2,
                            text_ctx=16),
}
# name -> (model_parallel, fsdp, the LayerNorm and MLP kernels' plain versions)
GSPMD_CASES = {
    "fsdp_4": (1, True, False),
    "tp_2x2": (2, False, False),
    "fsdp_tp_2x2": (2, True, False),
    "tp_1x4": (4, False, False),
    "fsdp_tp_2x2_fused": (2, True, True),
}
GSPMD_SAVE_CASE = "fsdp_tp_2x2"
COCA = "coca-S-test"
COCA_P = 2
INT8_MLP = (64, 4.0)       # width, mlp_ratio of the int8 MLP check
STEP_LR = (1e-3, 10, 100)          # cosine_lr(base, warmup, total)
STEP_WD = 0.1
TINY = "ViT-S-16-test-colxlip"


def rows(x: np.ndarray, rank: int, world: int) -> np.ndarray:
    b = x.shape[0] // world
    return x[rank * b:(rank + 1) * b]


def loss_cases(suite: str) -> list:
    """The names of ``LOSS_CASES`` that ``suite`` runs."""
    return [name for name, (kind, _) in LOSS_CASES.items() if kind in LOSS_SUITES[suite]]


def run_losses(rank: int, world: int, inputs, out: dict, suite: str = "losses") -> None:
    from colxlip_tpu_torch.losses import clip_loss, colclip_loss, distill_clip_loss, siglip_loss
    from colxlip_tpu_torch.parallel.collectives import gather_features, ring_shift

    local = {k: torch.from_numpy(rows(inputs[k], rank, world))
             for k in inputs.files if not k.startswith("cot_")}
    scale = torch.tensor(LOSS_SCALE)
    if suite == "siglip":
        try:
            siglip_loss(local["image"], local["text"], scale, axis_name="data",
                        dist_impl="ring")
        except ValueError as e:
            out["siglip_unknown_dist_impl"] = np.array(str(e))
    for name in loss_cases(suite):
        kind, kw = LOSS_CASES[name]
        if kind in ("siglip", "distill"):
            kw = dict(kw)
            feats = [local[k].clone().requires_grad_(True) for k in ("image", "text")]
            if kind == "siglip":
                bias = (torch.tensor(LOSS_BIAS, requires_grad=True) if kw.pop("bias", False)
                        else None)
                loss = siglip_loss(*feats, scale, bias, axis_name="data", **kw)
                if bias is not None:
                    feats.append(bias)
            else:
                loss = distill_clip_loss(*feats, scale, local["dist_image"], local["dist_text"],
                                         torch.tensor(LOSS_SCALE / 2), axis_name="data",
                                         output_dict=True, **kw)
                out[f"{name}/distill"] = loss["distill_loss"].detach().numpy()
                loss = loss["contrastive_loss"] + loss["distill_loss"]
            loss.backward()
            out[f"{name}/value"] = loss.detach().numpy()
            for i, f in enumerate(feats):
                out[f"{name}/grad{i}"] = f.grad.numpy()
            continue
        if kind in ("gather", "shift"):
            x = local["image"].clone().requires_grad_(True)
            if kind == "gather":
                y = gather_features(x, axis_name="data", **kw)
            else:
                y = ring_shift(x, "data", kw["shift"])
            cot = torch.from_numpy(inputs[f"cot_{kind}"][rank])
            if y.requires_grad:        # local loss: the gathered copy carries none
                (y * cot).sum().backward()
            out[f"{name}/value"] = y.detach().numpy()
            out[f"{name}/grad0"] = (torch.zeros_like(x) if x.grad is None else x.grad).numpy()
            continue
        feats = [local[k].clone().requires_grad_(True)
                 for k in ("image", "text", "token_image", "token_text")]
        if kind == "clip":
            loss = clip_loss(feats[0], feats[1], scale, axis_name="data", **kw)
            feats = feats[:2]
        else:
            loss = colclip_loss(*feats, scale, alpha=LOSS_ALPHA, axis_name="data",
                                text_mask=local["text_mask"], **kw)["total_loss"]
        loss.backward()
        out[f"{name}/value"] = loss.detach().numpy()
        for i, f in enumerate(feats):
            out[f"{name}/grad{i}"] = (f.grad if f.grad is not None
                                      else torch.zeros_like(f)).numpy()


def run_step(rank: int, world: int, inputs, out: dict) -> None:
    from colxlip_tpu_torch import factory
    from colxlip_tpu_torch.models import ColXLIP
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig, make_train_step
    from colxlip_tpu_torch.training import optim, schedules

    state = {k[len("param/"):]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith("param/")}
    images = torch.from_numpy(rows(inputs["images"], rank, world))
    texts_full = torch.from_numpy(rows(inputs["texts"], rank, world))
    for name, kw in STEP_CASES.items():
        kw = dict(kw)
        ctx = kw.pop("text_ctx", None)
        texts = texts_full if ctx is None else torch.from_numpy(
            rows(inputs[f"texts_ctx{ctx}"], rank, world))
        model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
        if rank == 0:
            model.load_state_dict(state, strict=True)
        # the other ranks start from their own random init: the step's
        # broadcast from rank 0 must replace it
        model.train()
        schedule = schedules.cosine_lr(*STEP_LR)
        opt = optim.create_optimizer(model, schedule, weight_decay=STEP_WD)
        cfg = dataclasses.replace(TrainStepConfig(loss_type="colclip"), **kw)
        step = make_train_step(model, opt, schedule, cfg, mesh="data")
        metrics = step(images, texts)
        for k, v in metrics.items():
            out[f"{name}/metric/{k}"] = np.float64(float(v))
        for k, p in model.named_parameters():
            out[f"{name}/param/{k}"] = p.detach().numpy()


def _gspmd_model(state, fused: bool):
    """The tiny model from ``state``, or from other seeded weights (None);
    ``fused``: built under both kernel variables."""
    from colxlip_tpu_torch import factory
    from colxlip_tpu_torch.models import ColXLIP

    names = ("COLXLIP_LN_IMPL", "COLXLIP_MLP_IMPL")
    old = {k: os.environ.get(k) for k in names}
    if fused:
        os.environ.update({k: "fused" for k in names})
    try:
        model = ColXLIP(factory.model_config(TINY), dtype=torch.float32)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    model.load_state_dict(state if state is not None else factory.create_model(
        TINY, "cpu", torch.float32, seed=5)[0].state_dict(), strict=True)
    return model.train()


def _local_state(model, optimizer) -> dict:
    """This rank's shards of the parameters and the moments, as numpy."""
    from colxlip_tpu_torch.parallel.gspmd import local

    out = {}
    for name, p in model.named_parameters():
        out[f"param/{name}"] = local(p).detach().numpy().copy()
        for k, v in optimizer.state[p].items():
            out[f"{k}/{name}"] = local(v).detach().numpy().copy()
    return out


def run_gspmd(rank: int, world: int, inputs, out_dir: str, out: dict) -> None:
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_optimizer_state_dict
    from torch.distributed.tensor import DTensor, Replicate

    from colxlip_tpu_torch.parallel import gspmd
    from colxlip_tpu_torch.parallel.mesh import create_mesh, data_index, data_size
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig
    from colxlip_tpu_torch.training import checkpoint as ck
    from colxlip_tpu_torch.training import optim, schedules

    state = {k[len("param/"):]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith("param/")}
    meshes = {}
    cfg = TrainStepConfig(loss_type="colclip", gather_with_grad=True)
    for name, (p, fsdp, fused) in GSPMD_CASES.items():
        mesh = meshes.setdefault(p, create_mesh(p))
        d, n = data_index(mesh), data_size(mesh)
        model = _gspmd_model(state, fused)
        gspmd.shard_state(model, mesh, fsdp=fsdp)
        schedule = schedules.cosine_lr(*STEP_LR)
        opt = optim.create_optimizer(model, schedule, weight_decay=STEP_WD)
        step = gspmd.make_train_step_gspmd(model, opt, schedule, cfg, mesh, fsdp=fsdp)
        metrics = step(torch.from_numpy(rows(inputs["images"], d, n)),
                       torch.from_numpy(rows(inputs["texts"], d, n)))
        for k, v in metrics.items():
            out[f"{name}/metric/{k}"] = np.float64(float(v))
        for k, v in gspmd.full_state_dict(model).items():
            out[f"{name}/param/{k}"] = v.numpy()
        for k, q in model.named_parameters():
            out[f"{name}/placements/{k}"] = np.array(repr(tuple(q.placements)))
            out[f"{name}/local_shape/{k}"] = np.array(gspmd.local(q).shape)
            out[f"{name}/moments_follow/{k}"] = np.bool_(all(
                isinstance(v, DTensor) and v.placements == q.placements
                and v.device_mesh == q.device_mesh
                for key, v in opt.state[q].items() if key != "step"))
            if len(q.placements) == 2 and isinstance(q.placements[1], Replicate):
                out[f"{name}/grad/{k}"] = gspmd.local(q.grad).numpy()
        if name == GSPMD_SAVE_CASE:
            saved = (model, opt, step.step, mesh)
            # the clip over sharded gradients scales each shard by the global
            # norm's factor: half the norm halves every whole gradient
            grads = [q.grad for q in model.parameters()]
            before = [g.full_tensor().clone() for g in grads]   # a replicated one aliases
            norm = float(torch.sqrt(sum(b.square().sum() for b in before)))
            optim.clip_by_global_norm_(grads, norm / 2)
            out["clip/norm"] = np.float64(norm)
            out["clip/max_rel_err"] = np.float64(max(
                float((g.full_tensor() - b / 2).abs().max() / b.abs().max().clamp_min(1e-30))
                for g, b in zip(grads, before)))
    model, opt, steps_done, mesh = saved
    ckpt_dir = os.path.join(out_dir, "ckpt")
    ck.save_checkpoint_sharded(ckpt_dir, ck.sharded_train_state(model, opt, steps_done),
                               epoch=1, name="gspmd")
    mine = _local_state(model, opt)
    # a sharded restore into a fresh sharded state from other weights
    fresh = _gspmd_model(None, False)
    gspmd.shard_state(fresh, mesh, fsdp=True)
    fresh_opt = optim.create_optimizer(fresh, 0.0, weight_decay=STEP_WD)
    restored = ck.restore_sharded_checkpoint(os.path.join(ckpt_dir, "epoch_1"),
                                             ck.sharded_train_state(fresh, fresh_opt, 0))
    out["restore/step"] = np.int64(ck.restore_sharded_train_state(restored["state"], fresh,
                                                                   fresh_opt))
    out["restore/epoch"] = np.int64(restored["epoch"])
    got = _local_state(fresh, fresh_opt)
    out["restore/bit_equal"] = np.bool_(got.keys() == mine.keys() and all(
        np.array_equal(got[k], mine[k]) for k in mine))
    # a whole state.pt (written by the test process) into the sharded layout
    whole = ck.load_native_checkpoint(str(inputs["whole_path"]))
    fresh = _gspmd_model(None, False)
    gspmd.shard_state(fresh, mesh, fsdp=True)
    fresh_opt = optim.create_optimizer(fresh, 0.0, weight_decay=STEP_WD)
    out["whole/step"] = np.int64(ck.restore_train_state(whole["state"], fresh, fresh_opt))
    for k, v in gspmd.full_state_dict(fresh).items():
        out[f"whole/param/{k}"] = v.numpy()
    full_opt = get_optimizer_state_dict(fresh, fresh_opt, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))
    for k, v in full_opt.get("state", {}).items():
        for key, t in v.items():
            out[f"whole/{key}/{k}"] = t.numpy()
    run_save_contracts(rank, ckpt_dir, out)


def _with_env(values: dict, build):
    """``build()`` with the environment variables of ``values`` set (None:
    unset), restored after."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return build()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _int8_mlp_check(rank: int, mesh, out: dict) -> None:
    """``MLP`` under ``COLXLIP_MLP_INT8=fwd``: the module at P = 1 (each rank
    whole) against the same module split over the mesh's model group by
    hand (c_fc's rows, c_proj's columns, as ``shard_state`` leaves them):
    the forward and the input and weight gradients; and the split that
    quantizes each shard with its own scales."""
    from colxlip_tpu_torch.models.layers import MLP, gelu
    from colxlip_tpu_torch.ops.quantization import int8_st_linear
    from colxlip_tpu_torch.parallel import tensor_parallel as tp
    from colxlip_tpu_torch.parallel.mesh import MODEL_AXIS

    width, ratio = INT8_MLP
    axis = tp.ModelAxis(mesh.get_group(MODEL_AXIS), mesh.size(1), mesh.get_local_rank(MODEL_AXIS))
    gen = torch.Generator().manual_seed(23)
    whole = _with_env({"COLXLIP_MLP_INT8": "fwd"},
                      lambda: MLP(width, ratio, gelu, dtype=torch.float32))
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x = torch.randn(3, 5, width, generator=gen) * 2.0
    dy = torch.randn(3, 5, width, generator=gen)
    hidden = whole.c_fc.weight.shape[0]
    part = hidden // axis.size
    lo, hi = axis.index * part, (axis.index + 1) * part
    split = _with_env({"COLXLIP_MLP_INT8": "fwd"},
                      lambda: MLP(width, ratio, gelu, dtype=torch.float32))
    with torch.no_grad():
        split.c_fc.weight = torch.nn.Parameter(whole.c_fc.weight[lo:hi].clone())
        split.c_fc.bias.copy_(whole.c_fc.bias)
        split.c_proj.weight = torch.nn.Parameter(whole.c_proj.weight[:, lo:hi].clone())
        split.c_proj.bias.copy_(whole.c_proj.bias)
    split.model_axis = axis
    results = {}
    for name, module in (("p1", whole), ("p2", split)):
        xi = x.clone().requires_grad_()
        y = module(xi)
        y.backward(dy)
        results[name] = y.detach()
        out[f"int8/{name}/y"] = y.detach().numpy()
        out[f"int8/{name}/dx"] = xi.grad.numpy()
        out[f"int8/{name}/c_fc.weight.grad"] = module.c_fc.weight.grad.numpy()
        out[f"int8/{name}/c_proj.weight.grad"] = module.c_proj.weight.grad.numpy()
        out[f"int8/{name}/c_proj.bias.grad"] = module.c_proj.bias.grad.numpy()
    with torch.no_grad():
        # each shard with its own scales: partial outputs summed in fp32
        h = int8_st_linear(x, split.c_fc.weight, split.c_fc.bias[lo:hi])
        y = int8_st_linear(gelu(h), split.c_proj.weight, torch.zeros(width))
        out["int8/naive/y"] = (tp.leave(y, axis) + split.c_proj.bias).numpy()
    out["int8/rows"] = np.array([lo, hi])


def run_gspmd_coca(rank: int, world: int, inputs, out_dir: str, out: dict) -> None:
    from colxlip_tpu_torch import factory
    from colxlip_tpu_torch.parallel import gspmd
    from colxlip_tpu_torch.parallel.mesh import create_mesh, data_index, data_size
    from colxlip_tpu_torch.parallel.train_step import TrainStepConfig
    from colxlip_tpu_torch.training import checkpoint as ck
    from colxlip_tpu_torch.training import optim, schedules

    mesh = create_mesh(COCA_P)
    d, n = data_index(mesh), data_size(mesh)
    fsdp = n > 1
    state = {k[len("param/"):]: torch.from_numpy(inputs[k]) for k in inputs.files
             if k.startswith("param/")}
    model, _ = factory.create_model(COCA, "cpu", torch.float32, seed=rank)
    model.load_state_dict(state, strict=True)
    model.train()
    gspmd.shard_state(model, mesh, fsdp=fsdp)
    schedule = schedules.cosine_lr(*STEP_LR)
    opt = optim.create_optimizer(model, schedule, weight_decay=STEP_WD)
    cfg = TrainStepConfig(loss_type="coca", gather_with_grad=True)
    step = gspmd.make_train_step_gspmd(model, opt, schedule, cfg, mesh, fsdp=fsdp)
    metrics = step(torch.from_numpy(rows(inputs["images"], d, n)),
                   torch.from_numpy(rows(inputs["coca_texts"], d, n)).long())
    for k, v in metrics.items():
        out[f"coca/metric/{k}"] = np.float64(float(v))
    for k, q in model.named_parameters():
        out[f"coca/grad/{k}"] = q.grad.full_tensor().numpy()
        out[f"coca/placements/{k}"] = np.array(repr(tuple(q.placements)))
    for k, v in gspmd.full_state_dict(model).items():
        out[f"coca/param/{k}"] = v.numpy()
    out["coca/save"] = np.array(ck.save_checkpoint_sharded(
        os.path.join(out_dir, "coca_ckpt"), ck.sharded_train_state(model, opt, step.step),
        epoch=1, name="coca"))

    _int8_mlp_check(rank, mesh, out)
    int8_model = _with_env({"COLXLIP_MLP_INT8": "fwd"}, lambda: _gspmd_model(
        {k[len("tiny/"):]: torch.from_numpy(inputs[k]) for k in inputs.files
         if k.startswith("tiny/")}, False))
    gspmd.shard_state(int8_model, mesh)
    opt = optim.create_optimizer(int8_model, schedule, weight_decay=STEP_WD)
    step = gspmd.make_train_step_gspmd(
        int8_model, opt, schedule, TrainStepConfig(loss_type="colclip", gather_with_grad=True),
        mesh)
    metrics = step(torch.from_numpy(rows(inputs["images"], d, n)),
                   torch.from_numpy(rows(inputs["texts"], d, n)))
    for k, v in metrics.items():
        out[f"int8_step/metric/{k}"] = np.float64(float(v))


def _contract_state(mesh, offset: float) -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    w = torch.arange(32, dtype=torch.float32).reshape(8, 4) + offset
    return {"step": 3, "params": {
        "w": distribute_tensor(w, mesh, [Shard(0)]),
        "scale": distribute_tensor(torch.tensor(7.0 + offset), mesh, [Replicate()])}}


def run_save_contracts(rank: int, root: str, out: dict) -> None:
    """``tests/test_sharded_ckpt.py``'s contracts on a 4-rank data mesh."""
    from colxlip_tpu_torch.parallel.mesh import create_mesh
    from colxlip_tpu_torch.training import checkpoint as ck

    mesh = create_mesh(1)
    d = os.path.join(root, "contracts")
    p = ck.save_checkpoint_sharded(d, _contract_state(mesh, 0.0), epoch=2, name="t")
    template = _contract_state(mesh, 100.0)
    restored = ck.restore_sharded_checkpoint(p, template)
    s = restored["state"]
    out["contract/path"] = np.array(p)
    out["contract/epoch"] = np.int64(restored["epoch"])
    out["contract/name"] = np.array(restored["name"])
    out["contract/step"] = np.int64(s["step"])
    out["contract/w"] = s["params"]["w"].full_tensor().numpy()
    out["contract/w_local"] = s["params"]["w"].to_local().numpy()
    out["contract/scale"] = np.float64(float(s["params"]["scale"].full_tensor()))
    out["contract/same_layout"] = np.bool_(
        s["params"]["w"].placements == template["params"]["w"].placements)
    p = ck.save_checkpoint_sharded(d, _contract_state(mesh, 0.0), epoch=1, name="t",
                                   most_recent=True, step_in_epoch=5)
    out["contract/sidecar_path"] = np.array(p)
    out["contract/sidecar"] = np.int64(ck.read_step_in_epoch(p))
    bg = os.path.join(root, "background")
    ck.save_checkpoint_sharded(bg, _contract_state(mesh, 0.0), epoch=1, name="t")
    p = ck.save_checkpoint_sharded(bg, _contract_state(mesh, 1.0), epoch=2, name="t",
                                   background=True, rotate_keep_epoch=2)
    out["contract/kept_before_finish"] = np.bool_(os.path.isdir(os.path.join(bg, "epoch_1")))
    ck.wait_for_saves()
    out["contract/rotated_after_finish"] = np.bool_(not os.path.isdir(os.path.join(bg, "epoch_1")))
    restored = ck.restore_sharded_checkpoint(p, _contract_state(mesh, 0.0))
    out["contract/background_w"] = restored["state"]["params"]["w"].full_tensor().numpy()


def run_main(rank: int, world: int, argv: list, out: dict) -> None:
    from colxlip_tpu_torch import main as main_mod
    from colxlip_tpu_torch.parallel import train_step

    stop_after = None
    if argv and argv[0] == "--stop-after-step":
        stop_after, argv = int(argv[1]), argv[2:]
    steps = []

    def capture(build):
        def wrapped(*a, **k):
            step = build(*a, **k)
            steps.append(step)
            return step
        return wrapped
    main_mod.make_train_step = capture(main_mod.make_train_step)
    main_mod.make_train_step_gspmd = capture(main_mod.make_train_step_gspmd)
    if stop_after is not None:
        call = train_step.TrainStep.__call__

        def call_then_signal(self, *a, **k):
            metrics = call(self, *a, **k)
            if self.step == stop_after:
                os.kill(os.getpid(), signal.SIGUSR1)
            return metrics
        train_step.TrainStep.__call__ = call_then_signal
    out["rc"] = np.int64(main_mod.main(argv))
    out["steps_run"] = np.int64(steps[0].step)
    for k, p in steps[0].model.named_parameters():
        # sharded state: this rank's shard and its placements
        if hasattr(p, "placements"):
            out[f"placements/{k}"] = np.array(repr(tuple(p.placements)))
            p = p.to_local()
        out[f"param/{k}"] = p.detach().numpy()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(suite: str, world: int, inputs_path: str, out_dir: str,
                argv=(), timeout: float = 300.0, extra_argv=None) -> list:
    """Run ``world`` ranks of ``suite`` at once (one intra-op thread each)
    and return their results, rank by rank; raises with the ranks' output
    when one fails. ``extra_argv``: rank -> arguments put before ``argv``."""
    import subprocess

    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), suite, str(r), str(world), str(port),
               inputs_path, out_dir, *(extra_argv or {}).get(r, ()), *argv]
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env),
                      log))
    failed = []
    try:
        for r, (p, log) in enumerate(procs):
            if p.wait(timeout=timeout) != 0:
                failed.append(r)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-4000:]
                       for r in failed)
        raise RuntimeError(f"{suite}: rank(s) {failed} failed:\n{logs}")
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def main() -> int:
    suite, rank, world, port, inputs_path, out_dir, *argv = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    out: dict = {}
    if suite == "main":
        # main joins the group itself, from the --dist-* flags
        run_main(rank, world, argv + ["--dist-coordinator", f"127.0.0.1:{port}",
                                      "--dist-num-processes", str(world),
                                      "--dist-process-id", str(rank)], out)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            inputs = np.load(inputs_path)
            if suite == "step":
                run_step(rank, world, inputs, out)
            elif suite == "gspmd":
                run_gspmd(rank, world, inputs, out_dir, out)
            elif suite == "gspmd_coca":
                run_gspmd_coca(rank, world, inputs, out_dir, out)
            else:
                run_losses(rank, world, inputs, out, suite)
        finally:
            dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

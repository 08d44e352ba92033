"""Sharded state and tensor parallelism: port of ``colxlip_tpu/parallel/gspmd.py``.

The JAX module writes the step with single-device semantics over the GLOBAL
batch and lets ``jit`` partition it: the batch over 'data', Megatron weight
sharding over 'model' (``--model-parallel P``), and with ``fsdp`` (ZeRO-3,
``--fsdp``) the parameters and AdamW moments over 'data' too. Here the
same layout is built from ``torch.distributed`` pieces on the mesh of
``parallel/mesh.py`` ``create_mesh``:

- ``partition_params``: one placement a mesh axis for each parameter, from
  its name and shape, leaf for leaf the JAX rules (``_spec_for``,
  ``_fsdp_extend``) on the JAX leaf it converts to (``convert.py``: an [out,
  in] weight is the transpose of the JAX [in, out] kernel; ``conv1`` [W, 3,
  p, p] is the [p p 3, W] kernel, whose leading dim shards like the
  patch-row dim). Under FSDP a parameter JAX leaves replicated over 'data'
  (the scalars, and any leaf with no dividing dim) stays whole on every
  rank of the data group. At a data axis of one the rule still shards (one
  shard is the whole tensor, the layout JAX's replication has), so FSDP2
  runs its collectives on a single card too.
- ``shard_state``: the parameters become DTensors with those placements.
  The FSDP units are ``fully_shard`` on each residual block, then on the
  root, with ``shard_placement_fn`` giving the table's data dim; under TP
  the sharded weights enter FSDP2 as DTensors on the 'model' axis, so the
  placements compose to the table's (data, model) pair. The leaves that
  stay whole over 'data' are FSDP2's ``ignored_params`` (it refuses 0-dim
  parameters) and are DTensors replicated over the whole mesh. AdamW's
  moments are created like their parameters, so they take its placements
  (what JAX's path-suffix matching gives).
- The compute runs on plain local tensors: a forward pre-hook on each
  block and on the root puts each DTensor parameter's ``to_local()`` in the
  module's ``__dict__`` (which shadows ``_parameters``) and the forward hook
  removes it, so the kernels' wrappers get the tensors they get on one
  device and autograd carries the gradients back to the DTensors. Under TP,
  ``MultiHeadAttention``, ``CrossAttention`` and ``MLP`` take their
  ``model_axis`` path (``parallel/tensor_parallel.py``).
- ``make_train_step_gspmd``: JAX's step. Each rank runs the forward on its
  data rows; every batch output the loss reads is gathered with gradient
  over the data group; every rank computes the same loss over the global
  batch (``compute_loss(out, cfg, None)``). The gradients of the sharded
  parameters are averaged over the data group by FSDP2's reduce-scatter;
  those of the whole ones by one coalesced all-reduce. Each rank's gather
  backward sums the W identical cotangents, so the average is the exact
  global gradient. ``grad_norm`` (and ``--grad-clip-norm``) is the norm of
  the global gradient (``training/optim.py`` ``global_norm``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..models.coca import CrossAttention
from ..models.layers import MLP, MultiHeadAttention, PatchDropout, ResidualAttentionBlock
from ..training.optim import global_norm
from .collectives import gather_features
from .mesh import DATA_AXIS, MODEL_AXIS, axis_sizes
from .tensor_parallel import ModelAxis
from .train_step import (_NON_BATCH_OUTPUTS, Metrics, TrainStepConfig, all_reduce_mean_,
                         broadcast_parameters, build_forward, clamp_logit_scale, compute_loss)

Placements = Tuple[Placement, ...]


def validate_gspmd_config(cfg: TrainStepConfig) -> None:
    """Refuse what the GSPMD step cannot express, with the JAX reasons: its
    loss sees global arrays, so every negative carries gradient and the
    explicit-collective modes are the data-parallel step's."""
    bad = []
    if cfg.local_loss:
        bad.append("--local-loss (sharded-logits form needs the explicit "
                   "shard_map axis)")
    if cfg.token_dist == "ring":
        bad.append("--token-dist ring (ppermute ring needs the explicit "
                   "shard_map axis)")
    if cfg.accum_freq > 1:
        bad.append("--accum-freq > 1 (cached-negative splicing is built on "
                   "the shard_map step)")
    if not cfg.gather_with_grad:
        bad.append("--gather-with-grad off (the GSPMD step always "
                   "differentiates through all gathered negatives; pass "
                   "--gather-with-grad, or use data-parallel for "
                   "stop-gradient semantics)")
    if bad:
        raise ValueError(
            "--model-parallel > 1 uses the GSPMD train step, which does not "
            "support: " + "; ".join(bad))


# the JAX rule's parents of column- and row-parallel kernels, as the port's
# parameter names end
_COLUMN = ("attn.in_proj_weight", "c_fc.weight", "q_proj.weight", "k_proj.weight",
           "v_proj.weight")
_ROW = ("out_proj.weight", "c_proj.weight")


def jax_view(name: str, shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the JAX leaf's shape, the port dim of each JAX dim) for a parameter of
    the port (``convert.py``'s layout): [out, in] weights are transposed
    kernels, ``conv1`` [W, 3, p, p] is the [p p 3, W] kernel whose rows run
    patch row, patch column, channel (so its leading dim shards as the
    patch-row dim 2), the rest are the JAX leaf as it is."""
    shape = tuple(shape)
    if len(shape) == 4 and name.endswith("conv1.weight"):
        w, c, ph, pw = shape
        return (ph * pw * c, w), (2, 0)
    if len(shape) == 2 and (name.endswith("in_proj_weight") or (
            name.endswith(".weight") and not name.endswith("token_embedding.weight"))):
        return (shape[1], shape[0]), (1, 0)
    return shape, tuple(range(len(shape)))


def _jax_spec(name: str, jax_shape, port_shape, dims, data: int, model: bool,
              fsdp: bool) -> List[Optional[str]]:
    """The JAX ``_spec_for`` then ``_fsdp_extend`` on one leaf: the mesh axis
    of each JAX dim (None: not sharded)."""
    entries: List[Optional[str]] = [None] * len(jax_shape)
    if model and len(jax_shape) >= 2:
        if name.endswith(_COLUMN):
            entries[1] = MODEL_AXIS
        elif name.endswith(_ROW):
            entries[0] = MODEL_AXIS
    if fsdp and jax_shape:
        # a JAX dim is a candidate when the port's dim it maps to splits the
        # same way (conv1's patch rows)
        cands = [i for i, (s, e) in enumerate(zip(jax_shape, entries))
                 if e is None and s >= data and s % data == 0 and port_shape[dims[i]] % data == 0]
        if cands:
            entries[max(cands, key=lambda i: jax_shape[i])] = DATA_AXIS
    return entries


def partition_params(shapes: Mapping[str, Sequence[int]],
                     axes: Union[DeviceMesh, Mapping[str, int]],
                     fsdp: bool = False) -> Dict[str, Placements]:
    """name -> one placement for each mesh axis ('data', then 'model' where
    the mesh has it), for parameters of these names and shapes on a mesh of
    these axis sizes. ``Shard(d)`` shards the port's dim d."""
    sizes = axis_sizes(axes) if isinstance(axes, DeviceMesh) else dict(axes)
    order = [DATA_AXIS] + ([MODEL_AXIS] if MODEL_AXIS in sizes else [])
    out = {}
    for name, shape in shapes.items():
        jax_shape, dims = jax_view(name, shape)
        entries = _jax_spec(name, jax_shape, tuple(shape), dims, sizes[DATA_AXIS],
                            MODEL_AXIS in sizes, fsdp)
        out[name] = tuple(Shard(dims[entries.index(a)]) if a in entries else Replicate()
                          for a in order)
    return out


@dataclasses.dataclass
class Layout:
    """What ``shard_state`` did to a model: the mesh, whether FSDP2 holds the
    state, and the names of the parameters that stay whole over 'data'
    (their gradients are averaged by the step)."""
    mesh: DeviceMesh
    fsdp: bool
    whole_over_data: Tuple[str, ...]


def _local_slice(t: torch.Tensor, mesh: DeviceMesh, placements: Placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``placements``."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = t.shape[pl.dim] // mesh.size(i)
            t = t.narrow(pl.dim, coord[i] * n, n)
    return t.contiguous()


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod_name, _, leaf = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), leaf


def _local_view_hooks(module: nn.Module, skip: Sequence[nn.Module]) -> None:
    """While ``module`` runs forward, every DTensor parameter of its subtree
    (outside the modules of ``skip``) reads as its ``to_local()``."""
    skipped = {id(p) for m in skip for p in m.parameters()}
    owners = [(*_owner(module, n), id(p)) for n, p in module.named_parameters()]
    owners = [(m, leaf) for m, leaf, pid in owners if pid not in skipped]
    swapped: List[Tuple[nn.Module, str]] = []

    def pre(mod, args):
        for m, leaf in owners:
            p = m._parameters.get(leaf)
            if isinstance(p, DTensor) and leaf not in m.__dict__:
                m.__dict__[leaf] = p.to_local()
                swapped.append((m, leaf))

    def post(mod, args, out):
        while swapped:
            m, leaf = swapped.pop()
            m.__dict__.pop(leaf, None)

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post, always_call=True)


def _check_model_parallel(model: nn.Module, p: int) -> None:
    """Refuse by name what the 'model' axis cannot split: heads or hidden
    widths that P does not divide."""
    for name, m in model.named_modules():
        if isinstance(m, (MultiHeadAttention, CrossAttention)) and m.heads % p:
            raise ValueError(f"--model-parallel {p} does not divide the {m.heads} heads "
                             f"of {name}")
        if isinstance(m, MLP):
            hidden = m.c_fc.weight.shape[0]
            if hidden % p:
                raise ValueError(f"--model-parallel {p} does not divide the MLP hidden width "
                                 f"{hidden} of {name}")


def shard_state(model: nn.Module, mesh: DeviceMesh, fsdp: bool = False) -> Layout:
    """Place ``model``'s parameters on ``mesh`` by ``partition_params``, in
    place (build the optimizer after this call). Every rank starts from rank
    0's values. Returns the layout, also kept as ``model.gspmd_layout``."""
    sizes = axis_sizes(mesh)
    p = sizes.get(MODEL_AXIS, 1)
    if MODEL_AXIS in sizes:
        _check_model_parallel(model, p)
    broadcast_parameters(model, dist.group.WORLD)
    placements = partition_params({n: q.shape for n, q in model.named_parameters()},
                                  sizes, fsdp=fsdp)
    if MODEL_AXIS in sizes:
        axis = ModelAxis(mesh.get_group(MODEL_AXIS), p, mesh.get_local_rank(MODEL_AXIS))
        for m in model.modules():
            if isinstance(m, (MultiHeadAttention, CrossAttention, MLP)):
                m.model_axis = axis
    blocks = [m for m in model.modules() if isinstance(m, ResidualAttentionBlock)]
    for block in blocks:
        _local_view_hooks(block, ())
    _local_view_hooks(model, blocks)

    data_mesh = mesh[DATA_AXIS] if MODEL_AXIS in sizes else mesh
    managed: Dict[int, int] = {}      # id of an FSDP2 parameter -> its data dim
    whole = []
    for name, param in list(model.named_parameters()):
        pl = placements[name]
        owner, leaf = _owner(model, name)
        if fsdp and isinstance(pl[0], Shard):
            value = param.detach()
            if MODEL_AXIS in sizes:
                value = DTensor.from_local(_local_slice(value, mesh[MODEL_AXIS], pl[1:]),
                                           mesh[MODEL_AXIS], pl[1:], run_check=False)
        else:
            whole.append(name)
            value = DTensor.from_local(_local_slice(param.detach(), mesh, pl), mesh, pl,
                                       run_check=False)
        new = nn.Parameter(value, requires_grad=param.requires_grad)
        owner.register_parameter(leaf, new)
        if fsdp and isinstance(pl[0], Shard):
            managed[id(new)] = pl[0].dim
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        ignored = {q for n, q in model.named_parameters() if n in whole}

        def placement_fn(param):
            return Shard(managed[id(param)])

        for block in blocks:
            fully_shard(block, mesh=data_mesh, shard_placement_fn=placement_fn,
                        ignored_params=ignored)
        fully_shard(model, mesh=data_mesh, shard_placement_fn=placement_fn,
                    ignored_params=ignored)
    layout = Layout(mesh, fsdp, tuple(whole))
    model.gspmd_layout = layout
    return layout


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if isinstance(t, DTensor) else t


class GspmdStep:
    """``step(images, texts) -> metrics`` on a model placed by
    ``shard_state``; ``images`` and ``texts`` are this rank's data rows (the
    P ranks of one data index feed the same rows)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig,
                 mesh: DeviceMesh, teacher: Optional[nn.Module] = None, fsdp: bool = False):
        validate_gspmd_config(cfg)
        layout = getattr(model, "gspmd_layout", None)
        if layout is None or layout.fsdp != fsdp or layout.mesh is not mesh:
            raise ValueError("make_train_step_gspmd: place the model first with "
                             f"shard_state(model, mesh, fsdp={fsdp}) on the same mesh")
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.cfg = cfg
        self.teacher = teacher if teacher is None else teacher.eval()
        self.forward = build_forward(model, cfg, teacher)
        self.group = mesh.get_group(DATA_AXIS)
        whole = set(layout.whole_over_data)
        self.whole = [q for n, q in model.named_parameters() if n in whole and q.requires_grad]
        self.step = 0

    def __call__(self, images: torch.Tensor, texts: torch.Tensor) -> Metrics:
        params = [q for q in self.model.parameters() if q.requires_grad]
        for q in params:
            q.grad = None
        out = self.forward(images, texts)
        b = images.shape[0]
        out = {k: gather_features(v, axis_name=self.group, gather_with_grad=True)
               if (k not in _NON_BATCH_OUTPUTS and isinstance(v, torch.Tensor) and v.ndim >= 1
                   and v.shape[0] == b) else v
               for k, v in out.items()}
        losses = compute_loss(out, self.cfg, None)
        losses["total_loss"].backward()
        for q in params:
            if q.grad is None:
                q.grad = torch.zeros_like(q)
        if self.whole:
            all_reduce_mean_([local(q.grad) for q in self.whole], self.group)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["logit_scale"] = out["logit_scale"].detach()
        metrics["grad_norm"] = global_norm(q.grad for q in params)
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        if self.cfg.clamp_logit_scale:
            clamp_logit_scale(self.model)
        self.step += 1
        return metrics


def make_train_step_gspmd(model: nn.Module, optimizer: torch.optim.Optimizer,
                          schedule: Optional[Callable[[int], float]], cfg: TrainStepConfig,
                          mesh: DeviceMesh, *, teacher: Optional[nn.Module] = None,
                          fsdp: bool = False) -> GspmdStep:
    """The GSPMD train step (``colxlip_tpu/parallel/gspmd.py``
    ``make_train_step_gspmd``) on a model placed by ``shard_state(model,
    mesh, fsdp)``; refuses what ``validate_gspmd_config`` refuses."""
    if any(isinstance(m, PatchDropout) and m.prob > 0 for m in model.modules()):
        raise NotImplementedError(
            "make_train_step_gspmd: vision_cfg.patch_dropout > 0 is refused, as in "
            "make_train_step")
    return GspmdStep(model, optimizer, schedule, cfg, mesh, teacher=teacher, fsdp=fsdp)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The whole parameters on rank 0's CPU (an empty dict on the other
    ranks): every rank must call it (JAX's ``process_allgather``)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    return get_model_state_dict(model, options=StateDictOptions(full_state_dict=True,
                                                                 cpu_offload=True))

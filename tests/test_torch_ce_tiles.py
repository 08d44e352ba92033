"""The tile algorithm of the bf16 streaming-CE backward kernels, emulated on
the CPU.

In bfloat16 ``csrc/fused_ce.cu`` computes dA (with the per-row dscale) and
dB with one tensor-core body, ``ce_bwd_mma_kernel<DC, DA>``: a block owns
rows of one matrix (a for dA, b for dB; 64 rows at D <= 512, 32 above) and
walks the other in tiles of 64 rows. Per tile it takes the logit tile
raw = X_own . X_stream^T one k-step of 16 features at a time from zero,
added in fp32; the epilogue makes dz = (exp(scale raw - lse) - onehot) g
with rows past either end masked to 0, adds dz * raw into dscale (dA),
and splits dz into dz_hi = bf16(dz) and dz_lo = bf16(dz - dz_hi); then
out += dz_hi . X_stream + dz_lo . X_stream, the tile's sum from zero added
to the fp32 output, and the output is scaled at the end. The wrapper pads
rows to a multiple of 8 features with zeros. A CUDA kernel cannot run
here, so this file writes the same algorithm in plain PyTorch (a bf16 x bf16
product is exact in fp32) and holds it against the unchanged plain versions
``fused_ce_bwd_da_plain`` / ``fused_ce_bwd_db_plain`` under ``chip_smoke.py``'s
bar (1e-4 of the largest |grad|, dscale included), and against the JAX
package's Pallas kernels in interpret mode through ``jax.vjp`` of
``fused_contrastive_ce``. A control rounds dz to bf16 once instead of
splitting it and fails the same bar where every label logit dominates
(b = a, scale 100). The emulation is used by nothing in the package.
"""
from __future__ import annotations

import importlib.util
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops.fused_ce import fused_contrastive_ce as jax_fused_ce
from colxlip_tpu_torch.ops import fused_ce

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = REPO / "colxlip_tpu_torch" / "csrc" / "fused_ce.cu"
WARPS = 8                               # kWarps
STREAM_ROWS = 64                        # kStreamRows: rows of the streamed matrix a tile
PAD = 8                                 # kPad: elements of padding a staged row
KSTEP = 16                              # features an mma k-step
CAPACITIES = (64, 128, 256, 512, 768)   # the feature capacities DC the dispatch takes
MAX_SHARED = 232448                     # common.cuh kMaxSharedBytes
CE_BWD_TOL = 1e-4
SHAPES = [
    # M, N, D, logit scale
    (256, 256, 512, 1 / 0.07),   # one step of the entry point
    (33, 129, 64, 30.0),         # ragged, M != N
    (100, 70, 40, 100.0),        # D = 40: a ragged k-step, the scale at its clamp
    (130, 200, 36, 20.0),        # D = 36: padded to 40 by the wrapper
    (70, 65, 768, 50.0),         # ViT-L-14's embed_dim: 32 own rows, one stage
]


def own_rows(capacity: int) -> int:
    """Cfg<DC>::kOwn."""
    return 64 if capacity <= 512 else 32


def capacity(d: int) -> int:
    """The feature capacity the dispatch picks for rows of d features."""
    return next(c for c in CAPACITIES if d <= c)


def shared_bytes(dc: int, stages: int) -> int:
    """Cfg<DC>::bytes(stages): the own tile, the stream stages with their
    lse / g / label rows, the two dz halves, dscale's partial sums."""
    own, rs = own_rows(dc), dc + PAD
    wc = WARPS // (own // 16)
    return (own * rs * 2 + stages * (STREAM_ROWS * rs * 2 + 3 * STREAM_ROWS * 4)
            + 2 * own * (STREAM_ROWS + PAD) * 2 + wc * own * 4)


def _inputs(m, n, d, scale, seed=0, tied=False):
    """Unit rows in bf16 (as the towers' l2_normalize returns them), labels,
    per-row cotangents g, and lse from the plain forward."""
    rng = np.random.default_rng(seed)

    def unit(rows):
        x = rng.standard_normal((rows, d))
        return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
            np.float32)).bfloat16()

    a = unit(m)
    b = a.clone() if tied else unit(n)
    labels = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
    g = torch.from_numpy((rng.random(m) / m).astype(np.float32))
    s = torch.tensor(scale, dtype=torch.float32)
    _, lse = fused_ce.fused_ce_fwd_plain(a, b, labels, s)
    return a, b, labels, s, lse, g


def _staged(x: torch.Tensor, row0: int, rows: int, width: int) -> torch.Tensor:
    """Rows row0 .. row0 + rows - 1 of x as a tile sees them: fp32, zeros past
    the last row and past the last feature."""
    out = torch.zeros(rows, width)
    live = x[row0:row0 + rows].float()
    out[:live.shape[0], :live.shape[1]] = live
    return out


def tiled_backward(a, b, labels, scale, lse, g, da: bool, split: bool = True):
    """The kernel's algorithm: dA [M, D] and dscale rows [M] (da), or dB
    [N, D]; ``split=False`` is the control that rounds dz to bf16 once."""
    m, d = a.shape
    n = b.shape[0]
    dp = -(-d // 8) * 8                   # the wrapper's padding
    kp = -(-dp // KSTEP) * KSTEP          # the k-steps the logit tile takes
    rows = own_rows(capacity(dp))
    own, stream = (a, b) if da else (b, a)
    own_n, stream_n = (m, n) if da else (n, m)
    scale = float(scale)
    labels = labels.long()
    out = torch.zeros(own_n, dp)
    dscale = torch.zeros(m)
    for o0 in range(0, own_n, rows):
        x = _staged(own, o0, rows, kp)
        own_idx = torch.arange(o0, o0 + rows)
        own_live = own_idx < own_n
        acc = torch.zeros(rows, kp)
        ds = torch.zeros(rows)
        for s0 in range(0, stream_n, STREAM_ROWS):
            y = _staged(stream, s0, STREAM_ROWS, kp)
            col_idx = torch.arange(s0, s0 + STREAM_ROWS)
            col_live = col_idx < stream_n
            raw = torch.zeros(rows, STREAM_ROWS)
            for k0 in range(0, kp, KSTEP):
                raw = raw + x[:, k0:k0 + KSTEP] @ y[:, k0:k0 + KSTEP].T
            if da:
                at = own_idx.clamp(max=m - 1)
                lse_t, g_t = lse[at][:, None], g[at][:, None]
                onehot = col_idx[None, :] == labels[at][:, None]
            else:
                at = col_idx.clamp(max=m - 1)
                lse_t, g_t = lse[at][None, :], g[at][None, :]
                onehot = own_idx[:, None] == labels[at][None, :]
            p = torch.exp(scale * raw - lse_t)
            dz = torch.where(own_live[:, None] & col_live[None, :],
                             (p - onehot.float()) * g_t, torch.zeros(()))
            if da:
                ds = ds + (dz * raw).sum(dim=1)
            hi = dz.bfloat16().float()
            part = hi @ y
            if split:
                part = part + (dz - hi).bfloat16().float() @ y
            acc = acc + part
        live = min(rows, own_n - o0)
        out[o0:o0 + live] = scale * acc[:live, :dp]
        if da:
            dscale[o0:o0 + live] = ds[:live]
    out = out[:, :d]
    return (out, dscale) if da else out


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _errors(a, b, labels, s, lse, g, split=True):
    da, ds = tiled_backward(a, b, labels, s, lse, g, True, split)
    db = tiled_backward(a, b, labels, s, lse, g, False, split)
    want_da, want_ds = fused_ce.fused_ce_bwd_da_plain(a, b, labels, s, lse, g)
    want_db = fused_ce.fused_ce_bwd_db_plain(a, b, labels, s, lse, g)
    return _rel(da, want_da), _rel(ds, want_ds), _rel(db, want_db)


def test_constants_are_the_kernels_own():
    """The emulation's tile sizes are the source's, its feature capacities
    the dispatch's, and its bar chip_smoke.py's."""
    src = SOURCE.read_text()
    for name, value in (("kWarps", WARPS), ("kStreamRows", STREAM_ROWS), ("kPad", PAD)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "static constexpr int kOwn = DC <= 512 ? 64 : 32;" in src
    assert [int(c) for c in re.findall(r"return launch<(\d+), DA>", src)] == list(CAPACITIES)
    assert [int(c) for c in re.findall(r"if \(x\.d <= (\d+)\) return launch<", src)] == \
        list(CAPACITIES[:-1])
    assert fused_ce.MAX_FEATURES == CAPACITIES[-1]
    assert "mma::mma_16816_rn(raw[2 * np]" in src        # k-steps from zero, added in fp32
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CE_BWD_TOL == CE_BWD_TOL


@pytest.mark.parametrize("dc", CAPACITIES)
def test_tiles_fit_and_ldmatrix_rows_are_conflict_free(dc):
    """Two stream stages fit in shared memory up to D = 512, one at 768; the
    tiles' and dz's row strides put the eight 16-byte rows of an ldmatrix
    phase in eight bank groups; the output a thread holds stays at most 128
    fp32 registers."""
    stages = 2 if shared_bytes(dc, 2) <= MAX_SHARED else 1
    assert stages == (2 if dc <= 512 else 1)
    assert shared_bytes(dc, stages) <= MAX_SHARED
    for rs in (dc + PAD, STREAM_ROWS + PAD):
        assert len({(r * rs * 2 // 16) % 8 for r in range(8)}) == 8, rs
    assert own_rows(dc) * dc // (WARPS * 32) <= 128


def test_wrapper_pads_rows_to_eight_features():
    a, b = torch.ones(5, 36, dtype=torch.bfloat16), torch.ones(7, 36, dtype=torch.bfloat16)
    pa, pb = fused_ce.mma_operands(a, b)
    assert pa.shape == (5, 40) and pb.shape == (7, 40)
    assert torch.equal(pa[:, :36], a) and not pa[:, 36:].any() and not pb[:, 36:].any()
    a, b = torch.ones(5, 40, dtype=torch.bfloat16), torch.ones(7, 40, dtype=torch.bfloat16)
    assert all(x is y for x, y in zip(fused_ce.mma_operands(a, b), (a, b)))


@pytest.mark.parametrize("m,n,d,scale", SHAPES)
def test_tiled_backward_matches_plain(m, n, d, scale):
    errs = _errors(*_inputs(m, n, d, scale))
    assert max(errs) <= CE_BWD_TOL, errs


def test_label_logits_that_dominate_need_the_split():
    """b = a at scale 100: every row's own column is its largest logit and
    the label term (p - 1) g is the largest of most rows. The split meets the
    bar; dz rounded to bf16 once (the control) does not."""
    args = _inputs(192, 192, 512, 100.0, seed=3, tied=True)
    assert max(_errors(*args)) <= CE_BWD_TOL
    control = _errors(*args, split=False)
    assert min(control[0], control[2]) > 2 * CE_BWD_TOL, control


def test_tiled_backward_matches_jax_pallas():
    """The emulated kernels against the JAX package's Pallas backward
    (interpret mode) through jax.vjp of the mean loss: g = 1 / M on every
    row; M != N, D = 40 and a ragged last tile."""
    m, n, d, scale = 70, 100, 40, 30.0
    a, b, labels, s, lse, _ = _inputs(m, n, d, scale, seed=5)
    g = torch.full((m,), 1.0 / m)

    def loss(a_, b_, s_):
        return jax_fused_ce(a_, b_, jnp.asarray(labels.numpy()), s_, block_m=8, block_n=128,
                            interpret=True)

    _, vjp = jax.vjp(loss, jnp.asarray(a.float().numpy()), jnp.asarray(b.float().numpy()),
                     jnp.float32(scale))
    want_da, want_db, want_ds = (torch.from_numpy(np.array(x)) for x in vjp(jnp.float32(1.0)))
    da, ds = tiled_backward(a, b, labels, s, lse, g, True)
    db = tiled_backward(a, b, labels, s, lse, g, False)
    assert _rel(da, want_da) <= CE_BWD_TOL
    assert _rel(db, want_db) <= CE_BWD_TOL
    np.testing.assert_allclose(ds.sum().item(), float(want_ds), rtol=CE_BWD_TOL)


def test_register_report_names_each_kernel_of_a_namespace(monkeypatch):
    """build.resource_usage keys each kernel by its name and template
    arguments without its namespaces, so the five capacities of both
    directions of ce_bwd_mma_kernel (in ce_mma) are five rows each, not one."""
    from colxlip_tpu_torch.ops import build

    entries = [("(anonymous namespace)::ce_mma::ce_bwd_mma_kernel<512, true>", 180, 0),
               ("(anonymous namespace)::ce_mma::ce_bwd_mma_kernel<768, false>", 150, 8),
               ("(anonymous namespace)::ce_fwd_kernel<float>", 64, 0),
               ("colxlip::stream_tile::reduce_partials_kernel<0>", 32, 0)]
    text = "".join(
        f"ptxas info    : Compiling entry function 'void {name}(int)' for 'sm_90a'\n"
        f"ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for name, regs, spill in entries)

    class Done:
        returncode, stderr = 0, text

        def __init__(self, stdout=""):
            self.stdout = stdout

    def run(cmd, input=None, **kwargs):
        return Done(input) if cmd[0] == "c++filt" else Done()

    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    assert build.resource_usage(["fused_ce"]) == {
        "ce_bwd_mma_kernel<512, true>": (180, 0, 0, 0),
        "ce_bwd_mma_kernel<768, false>": (150, 0, 8, 8),
        "ce_fwd_kernel<float>": (64, 0, 0, 0),
        "reduce_partials_kernel<0>": (32, 0, 0, 0)}

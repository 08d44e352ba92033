"""The tile algorithm of the bf16 MLP kernels, emulated on the CPU.

In bfloat16 ``csrc/fused_mlp.cu`` runs the MLP's products one at a time
through the GEMM tile of ``csrc/mlp_gemm.cuh`` (``mma.sync`` on
``ldmatrix`` fragments, K in steps of 64 through a ring of ``cp.async``
stages) over the rows in chunks of ``ops.fused_mlp.chunk_rows(H)``: forward
x W1^T (epilogue: h rounded twice, a = bf16(gelu(h))) then a W2 (+ b2);
backward x W1^T (h), dy W2^T (da stays fp32: dh = bf16(gelu'(h) da), a over
h, each warp's column sums of dh), a^T dy and dh^T x (the TN layout: A read
k-major through ``ldmatrix.trans``; the first chunk stores dW, later chunks
add), dh W1 (dx). A CUDA kernel cannot run here, so this file writes the
same algorithm in plain PyTorch: operands staged with zero fill past their
bounds (the weight-gradient products bound K at the chunk's real rows, and
the emulated workspace rows past them hold NaN, as uninitialised device
memory may), K summed in steps of 64 in order, every epilogue's roundings,
dW and the db1 partial rows added chunk by chunk, db1 reduced in partial
order. It also reads the fragment loaders' lane addresses out of
``csrc/mma_tile.cuh`` and checks, through an emulated ``ldmatrix``, that
each gives the m16n8k16 fragment of the block it names (the k-major A of
the TN products included). The emulation is used by nothing in the package.

It holds the forward to its per-element bar (``ops/fused_mlp_check.py``: the
exact function within what the tile's fp32 sums and the fp32 GELU allow),
checks the bar itself on constructed values and against two controls that
must fail it, holds the backward against the unchanged plain version
``fused_mlp_bwd_plain`` under ``chip_smoke.py``'s bf16 tolerance (2^-7 of
the largest |grad|), and both against the JAX package's Pallas kernels in
interpret mode under ``tests/test_torch_fused.py``'s bf16 bars (2e-2).
"""
from __future__ import annotations

import importlib.util
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colxlip_tpu.ops import fused_mlp as jax_mlp
from colxlip_tpu_torch.ops import fused_mlp, fused_mlp_check as bar_check

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "colxlip_tpu_torch" / "csrc"
BM = 128          # kBM: rows of a C tile
BK = 64           # kBK: k a stage
STAGES = 3        # kStages
WARPS = 8         # kWarps
WARP_N = 32       # kWarpN: columns a warp owns
PAD = 8           # kPad: elements of padding a staged row
BWD_TOL = 2.0 ** -7
JAX_TOL = 2e-2
SHAPES = [
    # rows, D, H, chunk rows
    (300, 64, 256, 128),       # three chunks, the last 44 rows
    (231, 128, 512, 128),      # the smoke test's ragged 3 x 77 rows: 128 + 103
    (200, 256, 1024, 256),     # one chunk, ragged inside its second row tile
    (130, 1024, 4096, 128),    # ViT-L's width: a chunk of 2 rows at the end
]


def _inputs(rows, d, h, seed=0):
    """x, w1 [H, D], b1, w2 [H, D], b2, dy in bf16 at a tower's scales at init."""
    rng = np.random.default_rng(seed)

    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)
                                ).bfloat16()

    return (t((rows, d), 1.0), t((h, d), d ** -0.5), t((h,), 0.1), t((h, d), h ** -0.5),
            t((d,), 0.1), t((rows, d), 1.0))


# ---------------------------------------------------------------------------
# the GEMM tile
# ---------------------------------------------------------------------------

def stage(op: torch.Tensor, rows: int, cols: int, rows_pad: int, cols_pad: int):
    """An operand as the tile's loads see it: elements [0, rows) x [0, cols)
    as stored (fp32), zeros elsewhere, whatever lies there in memory."""
    out = torch.zeros(rows_pad, cols_pad)
    out[:rows, :cols] = op[:rows, :cols].float()
    return out


def gemm(a_mk: torch.Tensor, b_kn: torch.Tensor, m: int, n: int, k: int) -> torch.Tensor:
    """C [m, n] fp32 of A [m, k] . B [k, n] as the tile sums it: both staged
    with zero fill to whole tiles, K in steps of BK in ascending order (a
    bf16 x bf16 product is exact in fp32)."""
    mp, np_, kp = -(-m // BM) * BM, -(-n // WARP_N) * WARP_N, -(-k // BK) * BK
    a, b = stage(a_mk, m, k, mp, kp), stage(b_kn, k, n, kp, np_)
    acc = torch.zeros(mp, np_)
    for k0 in range(0, kp, BK):
        acc += a[:, k0:k0 + BK] @ b[k0:k0 + BK]
    return acc[:m, :n]


def rnd(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to bf16 and read back (round_to<bf16>)."""
    return v.bfloat16().float()


def pre_activation(acc, bias):
    return rnd(rnd(acc) + bias.float())


def tiled_forward(x, w1, b1, w2, b2, approximate, chunk):
    """The bf16 forward: per chunk x W1^T (kNT, epilogue kEpiGelu) into the
    [chunk, H] workspace, then a W2 (kNN, kEpiBias)."""
    rows, d = x.shape
    h = w1.shape[0]
    out = torch.full((rows, d), float("nan"))
    ws = torch.full((min(rows, chunk), h), float("nan"))
    for r0 in range(0, rows, chunk):
        rc = min(chunk, rows - r0)
        xc = x[r0:r0 + rc]
        acc = gemm(xc, w1.T, rc, h, d)
        ws[:rc] = rnd(fused_mlp.kernel_gelu(pre_activation(acc, b1), approximate))
        acc = gemm(ws, w2, rc, d, h)
        out[r0:r0 + rc] = rnd(rnd(acc) + b2.float())
    return out.bfloat16()


def tiled_backward(x, w1, b1, w2, dy, approximate, chunk):
    """The bf16 backward: (dx, dw1, db1, dw2, db2), the schedule of
    ``bf16_bwd``. The workspace rows past a chunk's end hold NaN: a product
    that read them would poison its output."""
    rows, d = x.shape
    h = w1.shape[0]
    cap = min(rows, chunk)
    hid = torch.full((cap, h), float("nan"))
    dh = torch.full((cap, h), float("nan"))
    parts = torch.full((chunk // fused_mlp.DB1_ROWS, h), float("nan"))
    dx = torch.full((rows, d), float("nan"))
    dw1 = torch.full((h, d), float("nan"))
    dw2 = torch.full((h, d), float("nan"))
    db2 = dy.float().sum(0)
    for r0 in range(0, rows, chunk):
        rc, first = min(chunk, rows - r0), r0 == 0
        xc, dyc = x[r0:r0 + rc], dy[r0:r0 + rc]
        hid[:rc] = pre_activation(gemm(xc, w1.T, rc, h, d), b1)           # kEpiPre
        da = gemm(dyc, w2.T, rc, h, d)                                    # kEpiDh
        value, grad = fused_mlp.kernel_gelu_and_grad(hid[:rc], approximate)
        dh[:rc] = rnd(grad * da)
        hid[:rc] = rnd(value)
        tiles = -(-rc // BM) * BM // fused_mlp.DB1_ROWS
        for p in range(tiles):    # each warp's 64 rows, rows past rc adding nothing
            s = dh[p * 64:min(rc, (p + 1) * 64)].sum(0)
            parts[p] = s if first else parts[p] + s
        # kTN: A = the workspace read k-major, K = the chunk's real rows
        for dw, a_ws, b_in in ((dw2, hid, dyc), (dw1, dh, xc)):
            acc = gemm(a_ws.T, b_in, h, d, rc)
            dw[:] = acc if first else dw + acc
        dx[r0:r0 + rc] = rnd(gemm(dh, w1, rc, d, h))                      # kNN, kEpiRound
    db1 = torch.zeros(h)
    for p in range(2 * (-(-cap // BM))):
        db1 = db1 + parts[p]
    return dx.bfloat16(), dw1, db1, dw2, db2


def _rel(got, want, floor=1e-30):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(floor)).item()


def test_constants_are_the_kernels_own():
    """The emulation's tile sizes are the header's and the wrapper's, the
    bar's k-step is the tile's mma; the tolerance is chip_smoke.py's."""
    tile = (CSRC / "mlp_gemm.cuh").read_text()
    for name, value in (("kWarps", WARPS), ("kBM", BM), ("kBK", BK), ("kStages", STAGES),
                        ("kWarpN", WARP_N), ("kPad", PAD)):
        assert re.search(rf"constexpr int {name} = {value};", tile), name
    assert "mma.sync.aligned.m16n8k16" in (CSRC / "mma_tile.cuh").read_text()
    assert bar_check.K_STEP == 16 and "mma::mma_16816(acc" in tile
    assert "gemm::mainloop<L, BN>(acc" in (CSRC / "fused_mlp.cu").read_text()
    assert fused_mlp.GEMM_ROWS == BM
    # the db1 sums: one row a warp at 128 x 128 (warps 2 x 4, 64 rows each)
    assert fused_mlp.DB1_ROWS == BM // (WARPS // (128 // WARP_N))
    assert "launch_gemm<gemm::kNT, 128, kEpiDh>" in (CSRC / "fused_mlp.cu").read_text()
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FUSED_BWD_TOL["bfloat16"] == BWD_TOL
    assert "check.forward_bar(" in inspect.getsource(smoke.hold_mlp_forward)


def test_chunks_stay_in_l2_and_far_under_one_hidden_tensor():
    assert [fused_mlp.chunk_rows(h) for h in (2048, 3072, 4096)] == [3072, 2048, 1536]
    assert [fused_mlp.chunk_rows(h, False) for h in (2048, 3072, 4096)] == [6144, 4096, 3072]
    for h in (512, 2048, 3072, 4096, 5120):
        c, cf = fused_mlp.chunk_rows(h), fused_mlp.chunk_rows(h, backward=False)
        assert c % BM == 0 and 2 * c * h * 2 <= fused_mlp.L2_WORKSPACE_BYTES
        assert cf % BM == 0 and cf * h * 2 <= fused_mlp.L2_WORKSPACE_BYTES
    rows, d, h = 256 * 197, 768, 3072             # the vision tower at batch 256
    hidden = rows * h * 2                         # one [B, N, H] bf16 tensor: 295 MiB
    fwd, bwd = (fused_mlp.workspace_bytes(rows, d, h, b) for b in (False, True))
    tiles = 4096 * h * 2                          # the forward's one tile, the backward's two
    assert fwd == tiles                           # the chunk's a, nothing else
    assert bwd == tiles + 4 * (32 * h + 264 * d)  # db1 sums a warp's rows, db2 264 partials
    assert max(fwd, bwd) < 32 * 2**20 < hidden // 9
    # a short input takes one chunk of its own rows
    assert fused_mlp.workspace_bytes(231, 512, 2048, False) == 231 * 2048 * 2


@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("layout", ["NT", "NN", "TN"])
def test_staged_rows_are_conflict_free_and_two_blocks_fit(layout, bn):
    """Each tile's row stride puts the eight 16-byte rows of one ldmatrix
    phase in eight bank groups, and a block's three stages leave room for a
    second block on the multiprocessor (227 KB)."""
    a_rs = BM + PAD if layout == "TN" else BK + PAD
    b_rs = BK + PAD if layout == "NT" else bn + PAD
    for rs in (a_rs, b_rs):
        assert len({(r * rs * 2 // 16) % 8 for r in range(8)}) == 8, rs
    a = BK * a_rs if layout == "TN" else BM * a_rs
    b = bn * b_rs if layout == "NT" else BK * b_rs
    assert 2 * STAGES * (a + b) * 2 <= 232448


# ---------------------------------------------------------------------------
# fragment loaders: mma_tile.cuh's lane addresses through an emulated ldmatrix
# ---------------------------------------------------------------------------

def _lane_address(name: str):
    """The address expression of one loader of mma_tile.cuh, as a function of
    (lane, rs): the text after `p + ` in its ldmatrix call."""
    src = (CSRC / "mma_tile.cuh").read_text()
    body = re.search(rf"void {name}\(uint32_t \(&\w\)\[4\], const bf16\* p, int rs, "
                     rf"int lane\) \{{\s*(ldmatrix_x4(?:_trans)?)\(\w, p \+ (.*?)\);\s*\}}",
                     src, flags=re.S)
    assert body, name
    expr = " ".join(body.group(2).split())
    return body.group(1).endswith("_trans"), (lambda lane, rs: eval(expr, {}, {"lane": lane,
                                                                             "rs": rs}))


def ldmatrix_x4(smem: np.ndarray, addresses, trans: bool) -> np.ndarray:
    """regs[lane, j] = the pair lane receives in register j: row g, columns
    2t, 2t + 1 of matrix j (with .trans: rows 2t, 2t + 1 of column g); lane
    8 j + r gives the address of row r of matrix j."""
    regs = np.zeros((32, 4, 2), smem.dtype)
    for j in range(4):
        mat = np.stack([smem[addresses[8 * j + r]:addresses[8 * j + r] + 8] for r in range(8)])
        if trans:
            mat = mat.T
        for lane in range(32):
            g, t = divmod(lane, 4)
            regs[lane, j] = mat[g, 2 * t:2 * t + 2]
    return regs


def a_from_fragment(regs) -> np.ndarray:
    """The 16 x 16 A an m16n8k16 A fragment stands for (mma_tile.cuh)."""
    a = np.full((16, 16), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                    (g + 8, 2 * t + 8))):
            a[r, c:c + 2] = regs[lane, j]
    return a


def b_from_fragments(regs) -> np.ndarray:
    """The 16 x 16 B (k x n, two n-tiles) that registers 0-1 (n-tile 0) and
    2-3 (n-tile 1) stand for: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]."""
    b = np.full((16, 16), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(4):
            k0 = 2 * t + (8 if j % 2 else 0)
            b[k0:k0 + 2, g + 8 * (j // 2)] = regs[lane, j]
    return b


@pytest.mark.parametrize("name", ["ldm_a", "ldm_a_trans", "ldm_b", "ldm_b_trans"])
@pytest.mark.parametrize("rs", [BK + PAD, 64 + PAD, BM + PAD])
def test_fragment_loaders_give_the_block_they_name(name, rs):
    """Each loader, pointed at (row0, col0) of a staged tile with row stride
    rs, gives the fragment of the 16 x 16 block there: ldm_a A[m][k] =
    tile[m][k]; ldm_a_trans A[m][k] = tile[k][m] (the TN products' k-major
    A); ldm_b B[k][n] = tile[n][k]; ldm_b_trans B[k][n] = tile[k][n]."""
    trans, address = _lane_address(name)
    assert trans == name.endswith("_trans")
    rows = 48
    rng = np.random.default_rng(rs)
    smem = rng.standard_normal(rows * rs)
    tile = smem.reshape(rows, rs)
    for r0, c0 in ((0, 0), (16, 8), (32, min(rs, 72) - 24)):
        regs = ldmatrix_x4(smem, [r0 * rs + c0 + address(lane, rs) for lane in range(32)],
                           trans)
        block = tile[r0:r0 + 16, c0:c0 + 16]
        if name == "ldm_a":
            want, got = block, a_from_fragment(regs)
        elif name == "ldm_a_trans":
            want, got = block.T, a_from_fragment(regs)
        elif name == "ldm_b":
            want, got = block.T, b_from_fragments(regs)
        else:
            want, got = block, b_from_fragments(regs)
        np.testing.assert_array_equal(got, want)


def test_tn_fragments_multiply_to_a_transposed_product():
    """A 16 x 16 x 16 product from the TN loaders alone: ldm_a_trans on a
    k-major A tile and ldm_b_trans on a k-major B tile give A^T B."""
    _, a_addr = _lane_address("ldm_a_trans")
    _, b_addr = _lane_address("ldm_b_trans")
    rs = BM + PAD
    rng = np.random.default_rng(7)
    at = rng.standard_normal((16, rs))        # tile[k][m]
    bt = rng.standard_normal((16, rs))        # tile[k][n]
    a = a_from_fragment(ldmatrix_x4(at.ravel(), [a_addr(l, rs) for l in range(32)], True))
    b = b_from_fragments(ldmatrix_x4(bt.ravel(), [b_addr(l, rs) for l in range(32)], True))
    np.testing.assert_allclose(a @ b, at[:, :16].T @ bt[:, :16], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the chunk schedule against the plain versions and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("rows,d,h,chunk", SHAPES)
def test_tiled_forward_matches_plain(rows, d, h, chunk, approximate):
    """The tile-only forward (no element summed again) inside the per-element
    bar, as the plain version is: both differ from the exact function only
    by their fp32 sums' order."""
    x, w1, b1, w2, b2, _ = _inputs(rows, d, h)
    got = tiled_forward(x, w1, b1, w2, b2, approximate, chunk)
    bar = bar_check.forward_bar(x, w1, b1, w2, b2, approximate)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    report = bar_check.check_forward(got, bar)
    assert report["ok"], bar_check.describe(report)
    # outputs stay below 4 here: at most two steps of [2, 4), where a tie at
    # the bias add makes one step of T(q) two
    assert report["max_allowance"] <= 2 * 2.0 ** -6
    plain = bar_check.check_forward(fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate),
                                    bar)
    assert plain["ok"], bar_check.describe(plain)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("rows,d,h,chunk", SHAPES)
def test_tiled_backward_matches_plain(rows, d, h, chunk, approximate):
    x, w1, b1, w2, _, dy = _inputs(rows, d, h, seed=1)
    got = tiled_backward(x, w1, b1, w2, dy, approximate, chunk)
    want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
    for g, w, name in zip(got, want, ("dx", "dw1", "db1", "dw2", "db2")):
        assert g.shape == w.shape and torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= BWD_TOL, name


def test_one_chunk_or_many_give_the_same_function():
    """The chunk size moves only the order of the dW and db1 sums."""
    x, w1, b1, w2, b2, dy = _inputs(300, 64, 256, seed=2)
    assert torch.equal(tiled_forward(x, w1, b1, w2, b2, False, 128),
                       tiled_forward(x, w1, b1, w2, b2, False, 384))
    many = tiled_backward(x, w1, b1, w2, dy, False, 128)
    one = tiled_backward(x, w1, b1, w2, dy, False, 384)
    assert torch.equal(many[0], one[0])
    for a, b in zip(many[1:4], one[1:4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("v,want,step", [
    (1.0 + 2.0 ** -8, 1.0, 2.0 ** -7),                      # a midpoint: ties to even
    (1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -6, 2.0 ** -7),       # the other way
    (2.0 - 2.0 ** -9, 2.0, 2.0 ** -7),                       # carries into the next binade
    (-0.75 - 2.0 ** -10, -0.75, 2.0 ** -8),
    (0.0, 0.0, 2.0 ** -133),
])
def test_bf16_rounding_and_step(v, want, step):
    t = torch.tensor([v], dtype=torch.float64)
    assert bar_check.round_bf16(t).item() == want
    assert bar_check.round_bf16(t).item() == t.float().bfloat16().double().item()
    assert bar_check.bf16_step(t).item() == step


@pytest.mark.parametrize("q,err,bias,y,lo,hi", [
    # far from a midpoint of T(q): one value, bit-equal
    (1.25 + 2.0 ** -9, 2.0 ** -12, 0.0, 1.25, 1.25, 1.25),
    # within err of the midpoint 1.25 + 2^-8: one step either way
    (1.25 + 2.0 ** -8 - 2.0 ** -12, 2.0 ** -11, 0.0, 1.25, 1.25, 1.2578125),
    # on a midpoint with no error: ties to even only
    (1.25 + 2.0 ** -8, 0.0, 0.0, 1.25, 1.25, 1.25),
    # err of 1.5 steps: the interval crosses two midpoints and a binade
    (0.5, 1.5 * 2.0 ** -8, 0.0, 0.5, 0.494140625, 0.5078125),
    # the sum just above 4, the output just below: one step of q is two of y
    (4.015625 - 2.0 ** -12, 2.0 ** -10, -0.0625, 3.9375, 3.9375, 3.96875),
    # both candidates T(q) + b2 on midpoints of y's grid: ties to even make a
    # one-step difference of T(q) two steps of y
    (-2.1024708, 0.003, 0.0859375, -2.03125, -2.03125, -2.0),
])
def test_bar_counts_the_roundings(q, err, bias, y, lo, hi):
    """The output interval of T(T(q +- err) + b2) on constructed values."""
    got = bar_check.through_roundings(*(torch.tensor([v], dtype=torch.float64)
                                        for v in (q, err, bias)))
    assert [g.item() for g in got] == [y, lo, hi]


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_gelu_error_bound_covers_fp32(approximate):
    """The fp32 GELU (the plain version's, the kernels' formula) lies within
    gelu_error_bound of its float64 value at every bf16 h in [-8, 8]."""
    h = torch.arange(-8.0, 8.0, 2.0 ** -7, dtype=torch.float64)
    h = bar_check.round_bf16(torch.cat([h, h * 2.0 ** -5]))
    exact = fused_mlp.kernel_gelu(h, approximate)
    fp32 = fused_mlp.kernel_gelu(h.float(), approximate).double()
    bound = bar_check.gelu_error_bound(h, exact)
    assert ((fp32 - exact).abs() <= bound).all()
    assert ((fp32 - exact).abs() <= bound / 4).all()    # the doubling's margin, and more


def _truncating_tile_sum(a, b):
    """a @ b as an mma that adds each k-step's 16 exact products to the
    accumulator exactly and truncates the result to fp32 (float64 in, out)."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k0 in range(0, a.shape[1], 16):
        exact = acc + a[:, k0:k0 + 16] @ b[k0:k0 + 16]
        f = exact.float()
        toward_zero = torch.where(f.double().abs() > exact.abs(),
                                  torch.nextafter(f, torch.zeros_like(f)), f)
        acc = toward_zero.double()
    return acc


@pytest.mark.parametrize("rows,d,h", [(96, 768, 3072), (64, 1024, 4096)])
def test_sum_bound_covers_a_truncating_tile(rows, d, h):
    """sum_error_bound holds an accumulation that truncates once a k-step of
    16: on a layer's inputs (terms of both signs) with room, no element using
    half of it, and on terms all positive, where every truncation errs the
    same way and the partial sums grow to the whole sum."""
    x, w1, _, w2, _, _ = _inputs(rows, d, h, seed=6)
    mixed = (x.double(), w1.double().T)
    positive = (x.double().abs(), w2.double()[:d].abs())
    for (a, b), room in ((mixed, 0.5), (positive, 1.0)):
        err = (_truncating_tile_sum(a, b) - a @ b).abs()
        assert (err <= room * bar_check.sum_error_bound(a, b)).all()


@pytest.mark.parametrize("control", ["bf16 sums", "three steps"])
@pytest.mark.parametrize("rows,d,h,chunk", SHAPES[1:3])
def test_controls_fail_the_bar(rows, d, h, chunk, control):
    """The forward with its K sums kept in bf16 (rounded every k-step of 16),
    and the tile's output with one element moved three bf16 steps, both fail
    the bar that the tile passes."""
    x, w1, b1, w2, b2, _ = _inputs(rows, d, h, seed=7)
    bar = bar_check.forward_bar(x, w1, b1, w2, b2)
    out = tiled_forward(x, w1, b1, w2, b2, False, chunk)
    assert bar_check.check_forward(out, bar)["ok"]
    got = (bar_check.bf16_sum_forward(x, w1, b1, w2, b2) if control == "bf16 sums"
           else bar_check.moved_three_steps(out, bar))
    report = bar_check.check_forward(got, bar)
    assert not report["ok"] and report["outside"] >= 1
    if control == "three steps":
        assert report["outside"] == 1 and report["worst_steps"] >= 3


@pytest.mark.parametrize("variant", ["round h once", "round da"])
def test_the_epilogues_roundings_are_the_functions(variant):
    """h is the product rounded, the bias added, and rounded again; dh takes
    da in fp32. Either shortcut is a different function: it moves some
    elements of h (or dh) off the plain version's bits."""
    x, w1, b1, w2, _, dy = _inputs(256, 128, 512, seed=3)
    acc = x.float() @ w1.float().T
    want_h = fused_mlp._hidden(x, w1.float(), b1)
    assert torch.equal(pre_activation(acc, b1), want_h.float())
    if variant == "round h once":
        assert (rnd(acc + b1.float()) != want_h.float()).any()
    else:
        da = dy.float() @ w2.float().T
        grad = fused_mlp.kernel_gelu_and_grad(want_h, False)[1]
        assert (rnd(grad * rnd(da)) != rnd(grad * da)).any()


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_tiled_mlp_matches_jax_pallas(approximate):
    """The emulation against the Pallas kernels in interpret mode (W1 in the
    JAX kernel's layout [D, H]) on the same seeded inputs, in bf16."""
    rows, d, h = 72, 64, 256
    x, w1, b1, w2, b2, dy = _inputs(rows, d, h, seed=4)
    as_jax = [jnp.asarray(t.float().numpy(), jnp.bfloat16)
              for t in (x.reshape(3, 24, d), w1.T, b1, w2, b2)]
    want, vjp = jax.vjp(lambda *a: jax_mlp.fused_mlp(*a, approximate, 0, True), *as_jax)
    want_g = vjp(jnp.asarray(dy.reshape(3, 24, d).float().numpy(), jnp.bfloat16))
    got = tiled_forward(x, w1, b1, w2, b2, approximate, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(rows, d),
                               rtol=0, atol=JAX_TOL)
    got_g = tiled_backward(x, w1, b1, w2, dy, approximate, 128)
    want_np = [np.asarray(g, np.float32) for g in want_g]
    want_np[0] = want_np[0].reshape(rows, d)
    want_np[1] = want_np[1].T                       # dW1 [D, H] -> [H, D]
    for g, w, name in zip(got_g, want_np, ("dx", "dw1", "db1", "dw2", "db2")):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_TOL * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# float32: the CUDA-core walk, cut into feature slices past D = 768
# ---------------------------------------------------------------------------

OWN, STREAM = 32, 64          # stream_tile.cuh kOwn, kStream
FP32_FWD_TOL = 1e-5           # chip_smoke.py FUSED_FWD_TOL["float32"]


def fp32_walk_forward(x, w1, b1, w2, b2, approximate, slices):
    """``mlp_fwd_kernel<float, DPT>`` over a grid of row blocks x ``slices``
    feature slices of 32 DPT columns: each block takes 64 hidden units at a
    time (h from the full-D dot, a = gelu(h)) and adds a's product with the
    slice's columns of W2 unit by unit in order into its fp32 output, as
    ``accumulate`` does; b2 is added after the rounding."""
    rows, d = x.shape
    width = -(-d // slices) if slices == 1 else fused_mlp.FP32_SLICE_FEATURES
    out = torch.empty_like(x)
    for r0 in range(0, rows, OWN):
        xs = x[r0:r0 + OWN]
        for c0 in range(0, d, width):
            cols = slice(c0, min(d, c0 + width))
            acc = torch.zeros(xs.shape[0], cols.stop - c0)
            for h0 in range(0, w1.shape[0], STREAM):
                h = torch.matmul(xs, w1[h0:h0 + STREAM].T) + b1[h0:h0 + STREAM]
                a = fused_mlp.kernel_gelu(h, approximate)
                for s in range(a.shape[1]):
                    acc = acc + a[:, s:s + 1] * w2[h0 + s, cols]
            out[r0:r0 + OWN, cols] = acc + b2[cols]
    return out


def test_fp32_feature_slices_are_the_kernels_own():
    src = (CSRC / "fused_mlp.cu").read_text()
    assert "if (a.d <= 512 || a.d > 768) return launch_fwd<T, 16>(a, b2, out);" in src
    assert "if (a.d <= 512 || a.d > 768) return launch_bwd<T, 16>(a, o);" in src
    assert "return (d + 32 * DPT - 1) / (32 * DPT);" in src
    assert fused_mlp.FP32_SLICE_FEATURES == 32 * 16
    assert [fused_mlp.fp32_feature_slices(d) for d in (40, 768, 769, 1000, 1024, 1025, 4096)] \
        == [1, 1, 2, 2, 2, 3, 8]
    assert not hasattr(fused_mlp, "MAX_FEATURES")


@pytest.mark.parametrize("d", [1000, 1100])
def test_fp32_slices_cover_every_feature_and_keep_each_sum(d):
    """The cut walk gives every output element the same sum, in the same
    order, as one slice over all D would (bit for bit), and both match the
    plain version within the fp32 forward bar."""
    gen = torch.Generator().manual_seed(d)
    rows, h = 70, 96
    x = torch.randn(rows, d, generator=gen)
    w1 = torch.randn(h, d, generator=gen) * d ** -0.5
    b1 = torch.randn(h, generator=gen) * 0.1
    w2 = torch.randn(h, d, generator=gen) * h ** -0.5
    b2 = torch.randn(d, generator=gen) * 0.1
    slices = fused_mlp.fp32_feature_slices(d)
    assert (slices - 1) * fused_mlp.FP32_SLICE_FEATURES < d <= slices * fused_mlp.FP32_SLICE_FEATURES
    cut = fp32_walk_forward(x, w1, b1, w2, b2, False, slices)
    whole = fp32_walk_forward(x, w1, b1, w2, b2, False, 1)
    assert torch.equal(cut, whole)
    want = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, False)
    assert _rel(cut, want, 1.0) <= FP32_FWD_TOL

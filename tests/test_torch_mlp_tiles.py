"""The tile algorithms of the MLP kernels, emulated on the CPU: the bf16
products on the tensor-core tile, and the fp32 backward on the CUDA-core tile.

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

In float32 both directions run the same schedule on ``csrc/sgemm_tile.cuh``
(128 x 128 C tiles of fp32 fmaf chains, K in ascending order). The backward
goes over chunks of ``ops.fused_mlp.fp32_chunk_rows(H)``, dh W1 cut into
``fp32_dx_splits`` K slices added in slice order, db1 from each warp's
32-row column sums (a thread's 8 rows in order, then the xor butterfly over
its 4 row lanes); the forward over near-equal chunks of whole 128-row tiles
(``fp32_fwd_plan``), x W1^T with the GELU in its epilogue, then a W2 in
``fp32_k_splits`` K slices, added in slice order with b2 once after the sum.
``tiled_fp32_backward`` and ``tiled_fp32_forward`` write those walks with
every fmaf (a float64 product and sum rounded once to fp32) and are held to
``fused_mlp_bwd_plain`` / ``fused_mlp_plain`` and the JAX ``_bwd_call`` /
``_fwd_call`` in interpret mode at ``FUSED_BWD_TOL`` fp32 (1e-4 of the
largest |grad|) and ``FUSED_FWD_TOL`` fp32 (1e-5 of max(1, max|out|));
tests pin the header's and the wrapper's constants, the chunk and slice
rules, the workspace and the staging's bank and coalescing claims.
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


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The emulations are many small tensor operations: one intra-op thread,
    so that the suite's parallel workers do not oversubscribe the cores (six
    workers of eight threads each made this module several times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
# float32: the bf16 schedule on the CUDA-core GEMM tile
# ---------------------------------------------------------------------------

SG_BM, SG_BK, SG_STAGES, SG_PAD = 128, 16, 3, 4      # sgemm_tile.cuh kBM (= kBN), kBK, ...
SG_WARPS_M, SG_WARPS_N = 4, 2
FP32_FWD_TOL = 1e-5                                  # chip_smoke.py FUSED_FWD_TOL["float32"]
FP32_BWD_TOL = 1e-4                                  # chip_smoke.py FUSED_BWD_TOL["float32"]
FP32_SHAPES = [
    # rows, D, H, chunk rows
    (200, 64, 200, 128),     # ragged rows in two chunks, H not a multiple of the tile
    (300, 40, 100, 128),     # three chunks, the last 44 rows in 7 dx slices
]


def sgemm(a_mk: torch.Tensor, b_kn: torch.Tensor) -> torch.Tensor:
    """C = A . B as the tile sums it, fp32: every element one fmaf chain
    over K in ascending order from zero (the product exact in float64, the
    sum rounded to fp32 once a step), in place: K steps of three operations
    with no allocation."""
    at, b = a_mk.double().T.contiguous(), b_kn.double()
    acc = torch.zeros(at.shape[1], b.shape[1])
    step = torch.empty(acc.shape, dtype=torch.float64)
    for k in range(at.shape[0]):
        torch.outer(at[k], b[k], out=step)
        step.add_(acc)
        acc.copy_(step)
    return acc


def warp_column_sums(dh: torch.Tensor, rows: int) -> torch.Tensor:
    """The kEpiDh column sums of dh [rows, H]: [4 ceil(rows / 128), H], one
    row a warp's 32 rows, every warp of the chunk's grid (rows past ``rows``
    add nothing: a warp with none writes zeros). A thread of row lane t
    (0-3) sums its rows 4 t + 0..3, then 16 + 4 t + 0..3 in order; the
    butterfly adds lanes t ^ 1, then t ^ 2."""
    groups = SG_WARPS_M * -(-rows // SG_BM)
    out = torch.zeros(groups, dh.shape[1])
    for g in range(groups):
        lanes = []
        for t in range(4):
            s = torch.zeros(dh.shape[1])
            for r in (*range(4 * t, 4 * t + 4), *range(16 + 4 * t, 20 + 4 * t)):
                if 32 * g + r < rows:
                    s = s + dh[32 * g + r]
            lanes.append(s)
        out[g] = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return out


def tiled_fp32_backward(x, w1, b1, w2, dy, approximate, chunk, splits):
    """fused_mlp.cu fp32_bwd on fp32 x, dy [rows, D], w1, w2 [H, D]: (dx,
    dw1, db1, dw2, db2), with the workspace rows past a chunk's end NaN."""
    rows, d = x.shape
    h = w1.shape[0]
    cap = min(rows, chunk)
    hid = torch.full((cap, h), float("nan"))
    dh = torch.full((cap, h), float("nan"))
    parts = torch.full((4 * -(-cap // SG_BM), h), float("nan"))
    dx = torch.full((rows, d), float("nan"))
    dw1 = torch.full((h, d), float("nan"))
    dw2 = torch.full((h, d), float("nan"))
    steps = -(-h // SG_BK)
    db2 = dy.sum(0)
    for r0 in range(0, rows, chunk):
        rc, first = min(chunk, rows - r0), r0 == 0
        xc, dyc = x[r0:r0 + rc], dy[r0:r0 + rc]
        hid[:rc] = sgemm(xc, w1.T) + b1                                  # kEpiPre
        da = sgemm(dyc, w2.T)                                            # kEpiDh
        value, grad = fused_mlp.kernel_gelu_and_grad(hid[:rc], approximate)
        dh[:rc] = grad * da
        hid[:rc] = value
        sums = warp_column_sums(dh[:rc], rc)
        parts[:len(sums)] = sums if first else parts[:len(sums)] + sums
        for dw, a_ws, b_in in ((dw2, hid, dyc), (dw1, dh, xc)):         # kTN, K = rc
            acc = sgemm(a_ws[:rc].T, b_in)
            dw[:] = acc if first else dw + acc
        slices = fused_mlp.fp32_chunk_splits(rc, cap, d, h, splits, 132)
        if slices == 1:                                                  # kNN, kEpiRound
            dx[r0:r0 + rc] = sgemm(dh[:rc], w1)
        else:
            kslice = -(-steps // slices) * SG_BK
            total = torch.zeros(rc, d)
            for k0 in range(0, h, kslice):                               # reduce_partials
                total = total + sgemm(dh[:rc, k0:k0 + kslice], w1[k0:k0 + kslice])
            dx[r0:r0 + rc] = total
    db1 = torch.zeros(h)
    for p in range(len(parts)):
        db1 = db1 + parts[p]
    return dx, dw1, db1, dw2, db2


def _fp32_inputs(rows, d, h, seed=0):
    return [t.float() if t.dtype == torch.float32 else t
            for t in (torch.from_numpy(a) for a in _fp32_arrays(rows, d, h, seed))]


def _fp32_arrays(rows, d, h, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * std).astype(np.float32)
            for shape, std in (((rows, d), 1.0), ((h, d), d ** -0.5), ((h,), 0.1),
                               ((h, d), h ** -0.5), ((d,), 0.1), ((rows, d), 1.0))]


def test_fp32_tile_constants_are_the_kernels_own():
    """The emulation's tile, chunk and slice constants are the header's and
    the wrapper's; two blocks an SM fit; the kernel is launched at two blocks
    an SM; the tolerance is chip_smoke.py's."""
    tile = (CSRC / "sgemm_tile.cuh").read_text()
    src = (CSRC / "fused_mlp.cu").read_text()
    for name, value in (("kBM", SG_BM), ("kBN", SG_BM), ("kBK", SG_BK), ("kStages", SG_STAGES),
                        ("kPad", SG_PAD), ("kWarps", WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", tile), name
    assert f"constexpr int kWarpsM = {SG_WARPS_M}, kWarpsN = {SG_WARPS_N};" in tile
    assert "acc[i][j] = fmaf(a[i], b[j], acc[i][j]);" in tile
    assert "mma_16816" not in tile and "tf32" not in tile.lower().replace("no tf32", "")
    assert fused_mlp.SGEMM_ROWS == SG_BM and fused_mlp.SGEMM_K_STEP == SG_BK
    assert fused_mlp.FP32_DB1_ROWS == SG_BM // SG_WARPS_M
    assert "__launch_bounds__(sg::kThreads, 2)\nmlp_sgemm_kernel" in src
    assert fused_mlp._BLOCKS_PER_SM == 2
    smem = SG_STAGES * 2 * SG_BK * (SG_BM + SG_PAD) * 4
    assert 2 * smem <= 232448 and smem > 48 * 1024     # dynamic, after the attribute
    assert "const int kslice = (steps + splits - 1) / splits * sg::kBK;" in src
    assert "int((long long)splits * cap / rc), steps, kRedGroups}));" in src
    assert "const int splits = chunk_splits(rc, cap, d, h, call_splits, sms);" in src
    assert fused_mlp._MAX_CHUNK_SPLITS == 32
    assert "sg::kWarpsM * ((cap + sg::kBM - 1) / sg::kBM)" in src
    assert "return dispatch_fp32_bwd(a, o, static_cast<float*>(workspace), chunk_rows);" in src
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.FUSED_BWD_TOL["float32"] == FP32_BWD_TOL
    assert smoke.FUSED_FWD_TOL["float32"] == FP32_FWD_TOL


def test_fp32_chunks_stay_in_l2_and_under_one_hidden_tensor():
    assert [fused_mlp.fp32_chunk_rows(h) for h in (2048, 3072, 4096)] == [2048, 1280, 1024]
    for h in (512, 2048, 3072, 4096, 5120):
        c = fused_mlp.fp32_chunk_rows(h)
        assert c % SG_BM == 0 and 2 * c * h * 4 <= fused_mlp.FP32_L2_WORKSPACE_BYTES
    for rows, d, h in ((16 * 257, 1024, 4096), (256 * 197, 768, 3072)):
        hidden = rows * h * 4                          # one [B, N, H] fp32 tensor
        got = fused_mlp.workspace_bytes(rows, d, h, True, torch.float32)
        assert got < hidden, (rows, got, hidden)
        fwd = fused_mlp.workspace_bytes(rows, d, h, False, torch.float32)
        assert 0 < fwd < hidden, (rows, fwd, hidden)
    # the ViT-L tiles and dx's four K slices: 32 + 16 MiB and the sums
    cap = 1024
    assert fused_mlp.workspace_bytes(16 * 257, 1024, 4096, True, torch.float32) == 4 * (
        2 * cap * 4096 + 4 * 8 * 4096 + 264 * 1024 + 4 * cap * 1024)


def test_fp32_staging_is_conflict_free_and_coalesced():
    """stage_transposed: the 32 stores of a warp fall in 32 banks and its
    loads read 32 contiguous bytes of each of four rows; the products' float4
    reads of one k are 4 distinct addresses of A and 8 of B, contiguous."""
    rs = SG_BM + SG_PAD
    for warp in range(WARPS):
        for i in range(8):
            lanes = [32 * warp + lane for lane in range(32)]
            rows = [(t >> 3) + 32 * (i & 3) for t in lanes]
            ks = [(t & 7) + 8 * (i >> 2) for t in lanes]
            assert len({(k * rs + r) % 32 for k, r in zip(ks, rows)}) == 32
            by_row = {}
            for k, r in zip(ks, rows):
                by_row.setdefault(r, []).append(k)
            assert len(by_row) == 4 and all(sorted(v) == list(range(min(v), min(v) + 8))
                                            for v in by_row.values())
        wm, wn = warp // SG_WARPS_N, warp % SG_WARPS_N
        a_addr = {wm * 32 + (lane >> 3) * 4 for lane in range(32)}
        b_addr = {wn * 64 + (lane & 7) * 4 for lane in range(32)}
        assert len(a_addr) == 4 and max(a_addr) - min(a_addr) == 12
        assert len(b_addr) == 8 and max(b_addr) - min(b_addr) == 28
    assert (rs * 4) % 16 == 0                     # every staged row starts on 16 bytes


def test_fp32_thread_tiles_cover_the_block_once():
    """tile_row x tile_col over the 256 threads cover the 128 x 128 block,
    each element once."""
    seen = torch.zeros(SG_BM, SG_BM, dtype=torch.int32)
    for t in range(WARPS * 32):
        warp, lane = divmod(t, 32)
        for i in range(8):
            for j in range(8):
                r = (warp // SG_WARPS_N) * 32 + (lane >> 3) * 4 + (i & 3) + 16 * (i >> 2)
                c = (warp % SG_WARPS_N) * 64 + (lane & 7) * 4 + (j & 3) + 32 * (j >> 2)
                seen[r, c] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("rows,d,h,chunk", FP32_SHAPES)
def test_tiled_fp32_backward_matches_plain(rows, d, h, chunk, approximate):
    x, w1, b1, w2, _, dy = _fp32_inputs(rows, d, h, seed=8)
    splits = fused_mlp.fp32_dx_splits(rows, d, h, 132)
    got = tiled_fp32_backward(x, w1, b1, w2, dy, approximate, chunk, splits)
    want = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, approximate)
    for g, w, name in zip(got, want, ("dx", "dw1", "db1", "dw2", "db2")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= FP32_BWD_TOL, name


@pytest.mark.parametrize("rows,d,h", [(72, 64, 256), (70, 1000, 160)])
def test_tiled_fp32_backward_matches_jax_pallas(rows, d, h):
    """Against the JAX package's Pallas backward (``_bwd_call``, interpret
    mode) at fp32, W1 in the JAX layout [D, H]; at D = 1000 (no tile divides
    it, one short chunk) against the plain version too."""
    x, w1, b1, w2, _, dy = _fp32_inputs(rows, d, h, seed=9)
    b, n = 2, rows // 2
    want = jax_mlp._bwd_call(jnp.asarray(x.numpy().reshape(b, n, d)), jnp.asarray(w1.T.numpy()),
                             jnp.asarray(b1.numpy()), jnp.asarray(w2.numpy()),
                             jnp.asarray(dy.numpy().reshape(b, n, d)), False, 0, True)
    want = [np.array(t, np.float32) for t in want]
    want[0], want[1] = want[0].reshape(rows, d), want[1].T
    got = tiled_fp32_backward(x, w1, b1, w2, dy, False, fused_mlp.fp32_chunk_rows(h),
                              fused_mlp.fp32_dx_splits(rows, d, h, 132))
    plain = fused_mlp.fused_mlp_bwd_plain(x, w1, b1, w2, dy, False)
    for g, w, p, name in zip(got, want, plain, ("dx", "dw1", "db1", "dw2", "db2")):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=FP32_BWD_TOL * np.abs(w).max(), err_msg=name)
        assert _rel(g, p) <= FP32_BWD_TOL, name


def test_fp32_one_chunk_or_many_give_the_same_function():
    """The chunk moves only the order of the dW and db1 sums, and of the dx
    rows of a short last chunk (more K slices): the other dx rows (the same
    slices) are bit-equal, the rest within fp32's reordering."""
    x, w1, b1, w2, _, dy = _fp32_inputs(300, 64, 96, seed=10)
    many = tiled_fp32_backward(x, w1, b1, w2, dy, False, 128, 3)
    one = tiled_fp32_backward(x, w1, b1, w2, dy, False, 384, 3)
    assert fused_mlp.fp32_chunk_splits(44, 128, 64, 96, 3, 132) > 3
    assert torch.equal(many[0][:256], one[0][:256]) and torch.equal(many[4], one[4])
    for a, b in zip((many[0][256:], *many[1:4]), (one[0][256:], *one[1:4])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fp32_dx_slices_are_one_function():
    """dh W1 in one, two or four K slices: the same function within fp32's
    reordering (each slice from zero, the slices added in order)."""
    x, w1, b1, w2, _, dy = _fp32_inputs(130, 48, 200, seed=11)
    outs = [tiled_fp32_backward(x, w1, b1, w2, dy, False, 128, s)[0] for s in (1, 2, 4)]
    for o in outs[1:]:
        assert _rel(o, outs[0]) <= 1e-6
    assert not torch.equal(outs[0], outs[2])      # a different order, not the same sums


def test_fp32_short_chunks_take_more_dx_slices_within_the_scratch():
    """A short last chunk (ViT-L's 16 rows; the vision tower's 512) cuts its
    dx into more K slices, filling the card, within the scratch's slices of
    a full chunk; full chunks keep the call's count; none is empty."""
    assert fused_mlp.fp32_chunk_splits(1024, 1024, 1024, 4096, 4, 132) == 4
    assert fused_mlp.fp32_chunk_splits(16, 1024, 1024, 4096, 4, 132) == 32
    assert fused_mlp.fp32_chunk_splits(512, 1280, 768, 3072, 4, 132) == 10
    assert fused_mlp.fp32_chunk_splits(44, 128, 40, 100, 4, 132) == 7
    assert fused_mlp.fp32_chunk_splits(16, 1024, 1024, 4096, 1, 132) == 1
    for rc, cap, d, h, splits in ((16, 1024, 1024, 4096, 4), (44, 128, 40, 100, 4),
                                  (512, 1280, 768, 3072, 4), (3, 128, 1000, 4000, 4),
                                  (100, 128, 8, 33, 2)):
        got = fused_mlp.fp32_chunk_splits(rc, cap, d, h, splits, 132)
        steps = -(-h // SG_BK)
        per = -(-steps // got)
        assert splits <= got <= 32 and got * rc <= splits * cap, (rc, got)
        assert (got - 1) * per < steps <= got * per


# ---------------------------------------------------------------------------
# float32 forward: x W1^T (+ gelu) and a W2 on the same tile, chunked
# ---------------------------------------------------------------------------

def tiled_fp32_forward(x, w1, b1, w2, b2, approximate, chunk, splits):
    """fused_mlp.cu fp32_fwd on fp32 x [rows, D], w1, w2 [H, D]: near-equal
    chunks of whole 128-row tiles within ``chunk`` rows (chunk c is tiles
    [c T / n, (c + 1) T / n)); per chunk x W1^T (kNT, kEpiGelu: a =
    gelu(acc + b1)) into a workspace whose rows past the chunk hold NaN, then
    a W2 (kNN, K = H) in ``fp32_chunk_splits`` K slices of whole k-steps,
    each an fmaf chain from zero, added in slice order from zero with b2
    added once after the sum (reduce_partials' Finish), or in one launch
    (kEpiBias: acc + b2)."""
    rows, d = x.shape
    h = w1.shape[0]
    chunks, cap = fused_mlp.fp32_fwd_plan(rows, h, chunk)
    tiles, steps = -(-rows // SG_BM), -(-h // SG_BK)
    ws = torch.full((cap, h), float("nan"))
    out = torch.full((rows, d), float("nan"))
    for c in range(chunks):
        r0 = tiles * c // chunks * SG_BM
        rc = min(rows, tiles * (c + 1) // chunks * SG_BM) - r0
        ws[:rc] = fused_mlp.kernel_gelu(sgemm(x[r0:r0 + rc], w1.T) + b1, approximate)
        slices = fused_mlp.fp32_chunk_splits(rc, cap, d, h, splits, 132)
        if slices == 1:
            out[r0:r0 + rc] = sgemm(ws[:rc], w2) + b2
            continue
        kslice = -(-steps // slices) * SG_BK
        total = torch.zeros(rc, d)
        for k0 in range(0, h, kslice):
            total = total + sgemm(ws[:rc, k0:k0 + kslice], w2[k0:k0 + kslice])
        out[r0:r0 + rc] = total + b2
    return out


def _fp32_fwd_splits(rows, d, h, chunk):
    return fused_mlp.fp32_k_splits(fused_mlp.fp32_fwd_plan(rows, h, chunk)[1], d, h, 132)


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("rows,d,h,chunk", FP32_SHAPES)
def test_tiled_fp32_forward_matches_plain(rows, d, h, chunk, approximate):
    """Within FUSED_FWD_TOL fp32 of max(1, max|out|) of the plain version:
    ragged chunks, H no tile divides, the short chunk's a W2 in more K
    slices."""
    x, w1, b1, w2, b2, _ = _fp32_inputs(rows, d, h, seed=12)
    got = tiled_fp32_forward(x, w1, b1, w2, b2, approximate, chunk,
                             _fp32_fwd_splits(rows, d, h, chunk))
    want = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2, approximate)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want, 1.0) <= FP32_FWD_TOL


@pytest.mark.parametrize("rows,d,h", [(72, 64, 256), (70, 1000, 160)])
def test_tiled_fp32_forward_matches_jax_pallas(rows, d, h):
    """Against the JAX package's Pallas forward (``_fwd_call``, interpret
    mode) at fp32, W1 in the JAX layout [D, H]; D = 1000 is no multiple of
    the tile's 128 columns or its 16-deep k-steps."""
    x, w1, b1, w2, b2, _ = _fp32_inputs(rows, d, h, seed=13)
    want = jax_mlp._fwd_call(jnp.asarray(x.numpy().reshape(2, rows // 2, d)),
                             jnp.asarray(w1.T.numpy()), jnp.asarray(b1.numpy()),
                             jnp.asarray(w2.numpy()), jnp.asarray(b2.numpy()), False, 0, True)
    want = torch.from_numpy(np.array(want, np.float32).reshape(rows, d))
    chunk = fused_mlp.fp32_fwd_chunk_rows(h)
    got = tiled_fp32_forward(x, w1, b1, w2, b2, False, chunk, _fp32_fwd_splits(rows, d, h, chunk))
    assert torch.isfinite(got).all()
    assert _rel(got, want, 1.0) <= FP32_FWD_TOL


def test_fp32_forward_one_chunk_or_many_give_the_same_function():
    """The chunks move no sum of x W1^T, and the a W2 sums only where a
    chunk takes another count of K slices (the 44-row last chunk takes 6,
    the full ones 3, as one chunk of 300 does): those rows within fp32's
    reordering, the rest bit for bit."""
    x, w1, b1, w2, b2, _ = _fp32_inputs(300, 64, 96, seed=14)
    assert fused_mlp.fp32_fwd_plan(300, 96, 128) == (3, 128)
    assert fused_mlp.fp32_fwd_plan(300, 96, 384) == (1, 300)
    assert _fp32_fwd_splits(300, 64, 96, 128) == _fp32_fwd_splits(300, 64, 96, 384) == 3
    assert fused_mlp.fp32_chunk_splits(44, 128, 64, 96, 3, 132) == 6
    many = tiled_fp32_forward(x, w1, b1, w2, b2, False, 128, 3)
    one = tiled_fp32_forward(x, w1, b1, w2, b2, False, 384, 3)
    assert torch.equal(many[:256], one[:256])
    assert _rel(many[256:], one[256:], 1.0) <= 1e-6


@pytest.mark.parametrize("splits", [2, 3, 4])
def test_fp32_forward_split_product_is_its_slices_added_in_order(splits):
    """a W2 cut into K slices of whole k-steps (the kernel's kslice): each
    slice's product from zero, the slices added in order from zero, b2 once
    after the sum, bit for bit; the same function as one slice within
    fp32's reordering."""
    rows, d, h = 130, 48, 200
    x, w1, b1, w2, b2, _ = _fp32_inputs(rows, d, h, seed=15)
    assert fused_mlp.fp32_chunk_splits(rows, rows, d, h, splits, 132) == splits
    got = tiled_fp32_forward(x, w1, b1, w2, b2, False, 256, splits)
    a = fused_mlp.kernel_gelu(sgemm(x, w1.T) + b1, False)
    steps = -(-h // SG_BK)
    kslice = -(-steps // splits) * SG_BK
    bounds = list(range(0, h, kslice)) + [h]
    assert len(bounds) - 1 == splits and all(k % SG_BK == 0 for k in bounds[:-1])
    total = torch.zeros(rows, d)
    for k0, k1 in zip(bounds, bounds[1:]):
        total = total + sgemm(a[:, k0:k1], w2[k0:k1])
    assert torch.equal(got, total + b2)
    whole = tiled_fp32_forward(x, w1, b1, w2, b2, False, 256, 1)
    assert _rel(got, whole, 1.0) <= 1e-6


def test_fp32_forward_plan_and_workspace_are_the_sources():
    """The wrapper's near-equal chunks, K slices and workspace are the
    kernel's (fused_mlp.cu fp32_fwd, kn_product), at phase 8b's ViT-L MLP and
    the vision tower's; the fp32 forward is the GEMM tile's, with no
    owned-feature walk left."""
    src = (CSRC / "fused_mlp.cu").read_text()
    for line in ("const int tiles = (a.rows + sg::kBM - 1) / sg::kBM, per = chunk / sg::kBM;",
                 "const int chunks = (tiles + per - 1) / per;",
                 "const int cap = std::min(a.rows, (tiles + chunks - 1) / chunks * sg::kBM);",
                 "const int r0 = int((long long)tiles * c / chunks) * sg::kBM;",
                 "launch_sgemm<sg::kNT, VEC, kEpiGelu>(up, e_up, a.stream)",
                 "return reduce_partials(scratch, out, splits, rc * d, stream, "
                 "Finish{nullptr, bias, d});"):
        assert line in src, line
    assert src.count("kn_product<VEC>(") == 2           # a W2 and dh W1: one function
    for gone in ("mlp_fwd_kernel", "feature_slices", "launch_fwd"):
        assert gone not in src, gone
    assert not hasattr(fused_mlp, "fp32_feature_slices")
    assert not hasattr(fused_mlp, "FP32_SLICE_FEATURES")
    for h in (2048, 3072, 4096):
        c = fused_mlp.fp32_fwd_chunk_rows(h)
        assert c % SG_BM == 0 and c * h * 4 <= fused_mlp.FP32_L2_WORKSPACE_BYTES
        assert c >= 2 * fused_mlp.fp32_chunk_rows(h)
    assert fused_mlp.fp32_fwd_plan(16 * 257, 4096) == (3, 1408)
    assert fused_mlp.fp32_fwd_plan(256 * 197, 3072) == (19, 2688)
    for rows, h in ((16 * 257, 4096), (256 * 197, 3072), (300, 96), (127, 4096)):
        chunks, cap = fused_mlp.fp32_fwd_plan(rows, h)
        tiles = -(-rows // SG_BM)
        sizes = [min(rows, tiles * (c + 1) // chunks * SG_BM) - tiles * c // chunks * SG_BM
                 for c in range(chunks)]
        assert sum(sizes) == rows and max(sizes) == cap
        assert max(sizes) - min(sizes) <= SG_BM          # near-equal: a tile apart at most
        assert cap <= fused_mlp.fp32_fwd_chunk_rows(h)
    assert fused_mlp.fp32_k_splits(1408, 1024, 4096, 132) == 3
    assert fused_mlp.fp32_k_splits(2688, 768, 3072, 132) == 2
    assert fused_mlp.workspace_bytes(16 * 257, 1024, 4096, False, torch.float32) == 4 * (
        1408 * 4096 + 3 * 1408 * 1024)
    assert fused_mlp.workspace_bytes(256 * 197, 768, 3072, False, torch.float32) == 4 * (
        2688 * 3072 + 2 * 2688 * 768)

"""The tile algorithm of the MaxSim kernels, emulated on the CPU.

``csrc/maxsim.cu`` and ``csrc/maxsim_bwd.cu`` (with ``csrc/maxsim_tile.cuh``)
compute the similarities as one tensor-core product per image over the
flattened text rows, walk the features in chunks of 64, the image's columns
in groups with a running max, build the route pass's tie words from the
m16n8 accumulator fragments, and add dI in one fixed order. A CUDA kernel
cannot run here, so this file writes the same algorithm in plain PyTorch:
128-row blocks of flattened text rows (zero-filled past M * Lt), column
groups from the kernels' plan (zero-filled past Li, then -inf before the
max), bf16 operands multiplied exactly and summed in fp32 chunk by chunk
(fp32 inputs in fp32, the CUDA-core path), tie bits placed lane by lane as
the C fragment holds them and OR-ed over each quad,
the single tied token or -1, the settle pass for near-ties, and dI added
text row by text row in ascending order into the image tokens each group of
warps owns. It holds that algorithm against the unchanged plain versions
``maxsim_plain`` / ``maxsim_bwd_plain`` and
against the JAX package (``maxsim_pallas(..., interpret=True)`` forward, the
streaming custom VJP backward, whose tie rule the port follows) on seeded
numpy inputs. The emulation is used by nothing in the package.

Tolerances are ``chip_smoke.py``'s, unchanged (a test here pins that):
forward 1e-5 absolute on scores of unit-norm tokens in fp32 and bf16 (a bf16
product is exact in fp32, so only the summation order differs); backward
1e-5 (fp32) and 2^-7 (bf16: each gradient is rounded to bf16 once) of the
largest |grad|.
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

from colxlip_tpu.ops.maxsim import maxsim as jax_maxsim
from colxlip_tpu.ops.maxsim_pallas import maxsim_pallas
from colxlip_tpu_torch.ops import maxsim

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "colxlip_tpu_torch" / "csrc"
BLOCK_ROWS = 128      # kBlockRows: 8 warps of 16 rows
CHUNK = 64            # kDC: features a chunk
MAX_PAIRS = 16        # kMaxPairs: a column group is at most 256 columns
PAIR_STEPS = (4, 8, 13, 16)
DI_WARPS = 16         # kDiWarps
DI_MAX_TOKENS = 256   # kDiMaxTokens
DT_WARPS = 8          # kDtWarps
DT_SLICE = 4096       # kMaxD: features of a dT block's slice at most
MAXSIM_TOL = 1e-5
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = [
    # Lt, Li, D
    (77, 196, 512),    # the training shape: one group of 208 columns, 8 chunks
    (77, 257, 64),     # two groups of 208 columns, 49 live in the second
    (100, 577, 64),    # ViT-L/14 at 336 px with CLS: three groups, 19 tie words
    (12, 20, 40),      # one group of 64, a ragged 40-feature chunk
]
M, K = 3, 2
MODES = ("nonzero", "plain", "valid")


def plan(li):
    """The kernels' column plan (maxsim_tile.cuh `plan`): groups of 16 * np."""
    groups = -(-li // (16 * MAX_PAIRS))
    pairs = -(-(-(-li // groups)) // 16)
    return next(p for p in PAIR_STEPS if pairs <= p), groups


def _l2(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _inputs(lt, li, d, seed=0):
    """Unit-norm tokens; text 0 ends in zero rows (the 'nonzero' mask's
    case), text 1's token 0 has negative similarities with every image token
    of image 0, and image 1's tokens 3 and 7 are equal, with text 2's token 1
    equal to them: an exact tie; token 9 differs from them in one feature of
    about 0.02 by two percent: a near-tie inside the route pass's margin."""
    rng = np.random.default_rng(seed)
    t = _l2(rng.standard_normal((M, lt, d))).astype(np.float32)
    t[0, lt // 2:] = 0.0
    i = _l2(rng.standard_normal((K, li, d))).astype(np.float32)
    i[0] = _l2(np.abs(i[0])).astype(np.float32)
    t[1, 0] = -_l2(np.abs(t[1, 0])).astype(np.float32)
    i[1, 7] = i[1, 3]
    i[1, 9] = i[1, 3]                            # a near-tie, settled in feature order:
    j = np.abs(np.abs(i[1, 9]) - 0.02).argmin()  # one feature near 0.02 two percent smaller
    i[1, 9, j] *= 0.98
    t[2, 1] = i[1, 3]
    mask = (rng.random((M, lt)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    g = rng.standard_normal((M, K)).astype(np.float32)
    return t, i, mask, g


def _torch(t, i, mask, g, dtype):
    return (torch.from_numpy(t).to(dtype), torch.from_numpy(i).to(dtype),
            torch.from_numpy(mask), torch.from_numpy(g))


def _split(x):
    """fp32 -> (hi, lo) bf16 values as fp32: x = hi + lo + (below 2^-16 |x|)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def split_product(a, b):
    """The split-bf16 product the fp32 tile does not take (lo.hi + hi.lo +
    hi.hi, three tensor-core products a step)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def group_sims(rows, image_k, col0, np_, li):
    """sim of 128-row blocks of flattened text rows against one column group
    of one image: [blocks * 128, 16 np] fp32, as a warp's accumulators hold
    it after the last chunk; columns at or past li are -inf."""
    n_rows, d = rows.shape
    width = 16 * np_
    pad_rows = -(-n_rows // BLOCK_ROWS) * BLOCK_ROWS
    a = torch.zeros(pad_rows, d)
    a[:n_rows] = rows.float()                               # zero-filled rows
    b = torch.zeros(width, d)
    live = max(0, min(width, li - col0))
    b[:live] = image_k[col0:col0 + live].float()            # zero-filled columns
    acc = torch.zeros(pad_rows, width)
    for d0 in range(0, d, CHUNK):                           # features past D are zeros
        acc += a[:, d0:d0 + CHUNK] @ b[:, d0:d0 + CHUNK].T
    cols = col0 + torch.arange(width)
    return acc.masked_fill(cols[None, :] >= li, float("-inf"))


def near_margin(m):
    """maxsim_bwd.cu `near_margin`: 2^-12 of |max| (at least of 1e-6)."""
    return torch.clamp(m.abs(), min=1e-6) * 2.0 ** -12


def sequential_sim(t_rows, i_rows):
    """Similarities as sequential fp32 sums over the features, as the settle
    pass (and the plain version's fp32 product) takes them: [n, d] x [n, d]
    row by row. A bf16 product is exact in fp32, so this is the fmaf chain;
    for fp32 inputs the product is rounded once more than fmaf rounds it."""
    acc = torch.zeros(t_rows.shape[0])
    for e in range(t_rows.shape[1]):
        acc = acc + t_rows[:, e].float() * i_rows[:, e].float()
    return acc


def fragment_tie_words(sims, col0, row_max, li, words):
    """The route pass's tie words of one 16-row warp tile and one column
    group, built as the kernel builds them: lane (g, t) holds columns
    8 nt + 2t, 2t + 1 of rows g and g + 8 (the m16n8 C fragment); each lane
    shifts its two bits to 2t, the quad ORs them (shuffles 1 and 2), and the
    quad's first lane ORs the 8 bits into word c >> 5 at c & 31, c = col0 +
    8 nt, for the n-tiles that start below Li. ``row_max`` is the threshold:
    the route pass passes max - margin (its candidate words)."""
    hit = (sims >= row_max[:, None]).astype(np.uint64)
    n_tiles = sims.shape[1] // 8
    frag = hit.reshape(16, n_tiles, 4, 2)                   # [row, nt, lane t, column pair]
    lane_bits = (frag[..., 0] | frag[..., 1] << np.uint64(1)) << (
        np.uint64(2) * np.arange(4, dtype=np.uint64))
    quad = np.bitwise_or.reduce(lane_bits, axis=2)          # [row, nt]: 8 bits each
    out = np.zeros((16, words), np.uint64)
    for nt in range(n_tiles):
        c = col0 + 8 * nt
        if c < li:
            out[:, c >> 5] |= quad[:, nt] << np.uint64(c & 31)
    return out.astype(np.uint32)


def tiled_route(text, image, with_ties=True):
    """max_sim [M, K, Lt] fp32 by the forward's and route pass's tile, with
    the route pass's tie words [M, K, Lt, ceil(Li / 32)] and the single tied
    token or -1 [M, K, Lt] (None, None for the forward), after the settle
    pass: a row with more than one candidate (within the margin under the
    max), other than a zero row, takes each candidate again in feature
    order."""
    m, lt, d = text.shape
    k, li, _ = image.shape
    np_, groups = plan(li)
    words = -(-li // 32)
    rows = text.reshape(m * lt, d)
    max_sim = torch.empty(m * lt, k)
    ties = np.zeros((m * lt, k, words), np.uint32)
    for kk in range(k):
        sims = [group_sims(rows, image[kk], gi * 16 * np_, np_, li) for gi in range(groups)]
        row_max = torch.stack([s.amax(-1) for s in sims]).amax(0)   # running max: exact
        max_sim[:, kk] = row_max[:m * lt]
        if not with_ties:
            continue
        thresh = row_max - near_margin(row_max)
        for r0 in range(0, m * lt, 16):                             # one warp tile at a time
            live = min(16, m * lt - r0)
            for gi, s in enumerate(sims):
                w = fragment_tie_words(s[r0:r0 + 16].numpy(), gi * 16 * np_,
                                       thresh[r0:r0 + 16].numpy(), li, words)
                ties[r0:r0 + live, kk] |= w[:live]
    max_sim = max_sim.reshape(m, lt, k).permute(0, 2, 1).contiguous()
    if not with_ties:
        return max_sim, None, None
    count = np.unpackbits(ties.view(np.uint8), axis=-1).sum(-1)
    unsettled = (count > 1) & (max_sim.permute(0, 2, 1).reshape(m * lt, k) != 0).numpy()
    for r, kk in zip(*np.nonzero(unsettled)):                       # the settle pass
        cands = _tied(ties[r, kk], -1)
        vals = sequential_sim(rows[r].expand(len(cands), d), image[kk, cands])
        best = vals.max()
        ties[r, kk] = 0
        for q, v in zip(cands, vals):
            if v >= best:
                ties[r, kk, q >> 5] |= np.uint32(1 << (q & 31))
        max_sim[r // lt, kk, r % lt] = best
    ties = ties.reshape(m, lt, k, words).transpose(0, 2, 1, 3)
    count = np.unpackbits(ties.view(np.uint8), axis=-1).sum(-1)
    first = np.array([[[_first_bit(w) for w in row] for row in mk] for mk in ties])
    route_q = np.where(count == 1, first, -1)
    return max_sim, ties, route_q


def _first_bit(words):
    for w, v in enumerate(words):
        if v:
            return 32 * w + (int(v) & -int(v)).bit_length() - 1
    return -1


def _tied(ties_row, route_q):
    if route_q >= 0:
        return [int(route_q)]
    return [32 * w + b for w, v in enumerate(ties_row) for b in range(32) if (int(v) >> b) & 1]


def tiled_forward(text, image, mask_mode, text_mask):
    max_sim, _, _ = tiled_route(text, image, with_ties=False)
    return maxsim.masked_mean_from_maxsim(max_sim, mask_mode, text_mask)


def tiled_backward(text, image, g, mask_mode, text_mask):
    """coef from the route pass's own max, dT over each row's tied image
    tokens, and dI added text row by text row in ascending (m, n) order, in
    fp32; both rounded to the input dtype. (The kernel splits the image
    tokens among spans of at most 256 and, within a span, among 4 owner
    groups of warps by (q - q0) % 4, each warp of a group taking 32 of the
    slice's 128 features; every element of dI has one warp, which walks the
    rows in that same order, so the split changes no sum.)"""
    m, lt, d = text.shape
    k, li, _ = image.shape
    max_sim, ties, route_q = tiled_route(text, image)
    if mask_mode == "plain":
        coef = g[:, :, None].expand(m, k, lt) / lt
    else:
        w = (max_sim != 0).float() if mask_mode == "nonzero" else \
            text_mask[:, None, :].expand(m, k, lt)
        coef = g[:, :, None] * w / (w.sum(-1, keepdim=True) + 1e-8)
    tf, imf = text.float(), image.float()
    dt = torch.zeros(m, lt, d)
    for mm in range(m):
        for n in range(lt):
            for kk in range(k):
                c = coef[mm, kk, n]
                if c != 0:
                    for q in _tied(ties[mm, kk, n], route_q[mm, kk, n]):
                        dt[mm, n] += c * imf[kk, q]
    di = torch.zeros(k, li, d)
    for kk in range(k):
        for p in range(m * lt):                             # ascending (m, n)
            mm, n = divmod(p, lt)
            c = coef[mm, kk, n]
            if c == 0:
                continue
            tv = c * tf[mm, n]
            for q in _tied(ties[mm, kk, n], route_q[mm, kk, n]):
                di[kk, q] += tv
    return dt.to(text.dtype), di.to(image.dtype)


def dt_slices(d):
    """maxsim_bwd.cu `dt_slices` / `dt_slice_width`: as few slices as keep
    each within 4096 features, near-equal: (slices, width)."""
    slices = -(-d // DT_SLICE)
    return slices, -(-d // slices)


def sliced_dt(text, image, g, mask_mode, text_mask, slices=None):
    """The dT kernel's walk: one block per (m, n) and feature slice; warp w
    adds, for the images k = w, w + 8, ..., each tied token's slice times the
    coefficient into its own fp32 row, in k order and ascending q; the 8 rows
    are added in warp order. ``slices`` overrides the kernel's rule."""
    m, lt, d = text.shape
    k = image.shape[0]
    max_sim, ties, route_q = tiled_route(text, image)
    if mask_mode == "plain":
        coef = g[:, :, None].expand(m, k, lt) / lt
    else:
        w = (max_sim != 0).float() if mask_mode == "nonzero" else \
            text_mask[:, None, :].expand(m, k, lt)
        coef = g[:, :, None] * w / (w.sum(-1, keepdim=True) + 1e-8)
    imf = image.float()
    slices, width = dt_slices(d) if slices is None else (slices, -(-d // slices))
    dt = torch.zeros(m, lt, d)
    for f0 in range(0, slices * width, width):
        rows = torch.zeros(DT_WARPS, m, lt, min(width, d - f0))
        for warp in range(DT_WARPS):
            for kk in range(warp, k, DT_WARPS):
                for mm in range(m):
                    for n in range(lt):
                        c = coef[mm, kk, n]
                        if c != 0:
                            for q in _tied(ties[mm, kk, n], route_q[mm, kk, n]):
                                rows[warp, mm, n] += c * imf[kk, q, f0:f0 + width]
        total = torch.zeros(m, lt, rows.shape[-1])
        for warp in range(DT_WARPS):
            total = total + rows[warp]
        dt[..., f0:f0 + width] = total
    return dt.to(text.dtype)


def _jax_vjp(fn, args, cot):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return [np.asarray(x) for x in vjp(jnp.asarray(cot))]


def test_constants_are_the_kernels_own():
    """The emulation's plan and sizes are the header's and the sources'; the
    tolerances are chip_smoke.py's."""
    tile = (CSRC / "maxsim_tile.cuh").read_text()
    bwd = (CSRC / "maxsim_bwd.cu").read_text()
    for name, value in (("kWarps", 8), ("kDC", CHUNK), ("kMaxPairs", MAX_PAIRS)):
        assert re.search(rf"constexpr int {name} = {value};", tile), name
    assert "kBlockRows = kWarps * 16;" in tile and BLOCK_ROWS == 8 * 16
    assert ("pairs <= 4 ? 4 : pairs <= 8 ? 8 : pairs <= 13 ? 13 : 16" in tile
            and PAIR_STEPS == (4, 8, 13, 16))
    for name, value in (("kDiWarps", DI_WARPS), ("kDiMaxTokens", DI_MAX_TOKENS),
                        ("kDtWarps", DT_WARPS), ("kMaxD", DT_SLICE)):
        assert re.search(rf"constexpr int {name} = {value};", bwd), name
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.MAXSIM_TOL == MAXSIM_TOL
    for dtype, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        assert smoke.BWD_TOL[name] == BWD_TOL[dtype]


@pytest.mark.parametrize("li,want", [(1, (4, 1)), (20, (4, 1)), (64, (4, 1)), (65, (8, 1)),
                                     (196, (13, 1)), (208, (13, 1)), (209, (16, 1)),
                                     (256, (16, 1)), (257, (13, 2)), (577, (13, 3)),
                                     (4096, (16, 16))])
def test_plan_covers_every_column_once(li, want):
    np_, groups = plan(li)
    assert (np_, groups) == want
    assert groups * 16 * np_ >= li > (groups - 1) * 16 * np_


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_mode", MODES)
@pytest.mark.parametrize("lt,li,d", SHAPES)
def test_tiled_forward_matches_plain(lt, li, d, mask_mode, dtype):
    t, i, mask, _ = _torch(*_inputs(lt, li, d), dtype)
    got = tiled_forward(t, i, mask_mode, mask)
    want = maxsim.maxsim_plain(t, i, mask_mode=mask_mode, text_mask=mask)
    assert got.shape == (M, K) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=MAXSIM_TOL)


@pytest.mark.parametrize("mask_mode", MODES)
@pytest.mark.parametrize("lt,li,d", SHAPES)
def test_tiled_forward_matches_jax_pallas(lt, li, d, mask_mode):
    t, i, mask, _ = _inputs(lt, li, d)
    jmask = jnp.asarray(mask) if mask_mode == "valid" else None
    want = np.asarray(maxsim_pallas(jnp.asarray(t), jnp.asarray(i), mask_mode=mask_mode,
                                    text_mask=jmask, interpret=True))
    tt, ii, tmask, _ = _torch(t, i, mask, mask, torch.float32)
    got = tiled_forward(tt, ii, mask_mode, tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAXSIM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_mode", MODES)
@pytest.mark.parametrize("lt,li,d", SHAPES)
def test_tiled_backward_matches_plain(lt, li, d, mask_mode, dtype):
    t, i, mask, g = _torch(*_inputs(lt, li, d, seed=1), dtype)
    got = tiled_backward(t, i, g, mask_mode, mask)
    want = maxsim.maxsim_bwd_plain(t, i, g, mask_mode=mask_mode, text_mask=mask)
    for a, w, x in zip(got, want, (t, i)):
        assert a.dtype == dtype and a.shape == x.shape
        tol = BWD_TOL[dtype] * w.float().abs().max().item()
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("lt,li,d", SHAPES)
def test_tiled_backward_matches_jax_streaming(lt, li, d):
    """The streaming custom VJP (every tied token gets the full cotangent)."""
    t, i, mask, g = _inputs(lt, li, d, seed=2)
    fn = lambda a, b: jax_maxsim(a, b, impl="streaming", m_chunk=M)  # noqa: E731
    want_t, want_i = _jax_vjp(fn, [t, i], g)
    tt, ii, _, gg = _torch(t, i, mask, g, torch.float32)
    got_t, got_i = tiled_backward(tt, ii, gg, "nonzero", None)
    for a, w in ((got_t, want_t), (got_i, want_i)):
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=BWD_TOL[torch.float32] * np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_negative_row_and_exact_tie(dtype):
    """Text 1's token 0 against image 0: every similarity is negative, so
    the zero-filled columns of the last group must not count (Li = 20 leaves
    44 of the group's 64); image 1's tokens 3 and 7 tie for text 2's token 1,
    and token 9 comes within the margin: the settle pass drops 9, the tie
    words hold 3 and 7, route_q says 'several', and dI gives each of the two
    the full cotangent."""
    t, i, mask, g = _torch(*_inputs(12, 20, 40), dtype)
    max_sim, ties, route_q = tiled_route(t, i)
    sims = t[1, 0].float() @ i[0].float().T
    assert (sims < 0).all() and max_sim[1, 0, 0] < 0
    assert abs(max_sim[1, 0, 0] - sims.max()) <= MAXSIM_TOL
    s3, s9 = (t[2, 1].float() @ i[1, q].float() for q in (3, 9))
    assert 0 < s3 - s9 < near_margin(s3)                 # token 9 is a candidate
    assert ties[2, 1, 1, 0] == (1 << 3) | (1 << 7) and route_q[2, 1, 1] == -1
    # text 0's zero rows tie every token; every other row has one tied token
    assert (ties[0, :, 6:, 0] == (1 << 20) - 1).all() and (route_q[0, :, 6:] == -1).all()
    others = route_q.copy()
    others[0, :, 6:] = 0
    others[2, 1, 1] = 0
    assert (others >= 0).all()
    _, di = tiled_backward(t, i, g, "plain", None)
    assert torch.equal(di[1, 3], di[1, 7]) and di[1, 7].abs().max() > 1e-3


def test_tie_words_from_fragments_equal_a_direct_pack():
    """The lane-by-lane fragment packing gives the same words as packing
    (sim >= max) column by column, also when a group starts inside a word
    (Li = 577: groups of 208 columns start at 208 and 416)."""
    t, i, _, _ = _torch(*_inputs(100, 577, 64, seed=3), torch.bfloat16)
    _, ties, _ = tiled_route(t, i)
    rows = t.reshape(-1, 64).float()
    sims = rows @ i.float().reshape(-1, 64).T
    sims = sims.reshape(M * 100, K, 577)
    hit = (sims >= sims.amax(-1, keepdim=True)).numpy()
    padded = np.zeros((M * 100, K, 19 * 32), bool)
    padded[..., :577] = hit
    direct = (padded.reshape(M * 100, K, 19, 32) * (1 << np.arange(32, dtype=np.uint64))
              ).sum(-1).astype(np.uint32)
    direct = direct.reshape(M, 100, K, 19).transpose(0, 2, 1, 3)
    # the fp32 product here sums in another order than the tile's chunks:
    # compare the rows whose max is clear of its runner-up by more than that
    top2 = sims.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    clear |= (rows.abs().sum(-1) == 0)[:, None]             # zero rows: exact, every bit
    clear = clear.numpy().reshape(M, 100, K).transpose(0, 2, 1)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(ties[clear], direct[clear])


def test_fp32_inputs_need_fp32_products():
    """Why fp32 inputs take fp32 products on the CUDA cores and not the
    split-bf16 product: at the training shape the split product is off by
    about 2e-7 rms, more than the gap between the two largest similarities of
    dozens of the 5 M rows, and each such row would route its cotangent to
    another image token; fp32 products are off by about 1e-8. Both meet the
    forward's 1e-5 (a slice of the training shape: 16 texts, 256 images)."""
    gen = torch.Generator().manual_seed(0)
    t = torch.nn.functional.normalize(torch.randn(16 * 77, 512, generator=gen), dim=-1)
    img = torch.nn.functional.normalize(torch.randn(256 * 196, 512, generator=gen), dim=-1)
    exact = t.double() @ img.double().T
    top = exact.reshape(-1, 256, 196).topk(2, dim=-1).values
    gaps = (top[..., 0] - top[..., 1]).flatten()
    a, b = t[:2048], img[:2048]
    split = (split_product(a, b).double() - exact[:2048, :2048]).pow(2).mean().sqrt().item()
    fp32 = ((a @ b.T).double() - exact[:2048, :2048]).pow(2).mean().sqrt().item()
    assert fp32 < 3e-8 < 1e-7 < split < 1e-6
    at_risk = (gaps < split).sum().item() * 16       # 256 texts: 16 slices like this one
    assert at_risk >= 10 and (gaps < fp32).sum().item() * 16 < at_risk / 5


def test_dt_slices_rule():
    """One slice up to 4096 features (the kernel the parent ran), then as few
    near-equal slices as keep each within 4096; the source's rule."""
    bwd = (CSRC / "maxsim_bwd.cu").read_text()
    assert "return (d + kMaxD - 1) / kMaxD;" in bwd
    assert "return (d + dt_slices(d) - 1) / dt_slices(d);" in bwd
    assert "const dim3 dt_grid(unsigned(m) * unsigned(lt), dt_slices(d));" in bwd
    assert not hasattr(maxsim, "MAX_FEATURES")
    assert [dt_slices(d) for d in (1, 512, 4096, 4097, 4104, 8192, 8193)] == [
        (1, 1), (1, 512), (1, 4096), (2, 2049), (2, 2052), (2, 4096), (3, 2731)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sliced_dt_past_4096_features_matches_plain_and_jax(dtype):
    """D = 4104 (the width the backward used to refuse): dT in two feature
    slices of 2052 gives one slice's bits, element by element, and meets the
    plain backward's bar (fp32 1e-5, bf16 2^-7 of max|grad|) and, in fp32,
    the JAX streaming VJP's."""
    lt, li, d = 5, 20, 4104
    t, i, mask, g = _inputs(lt, li, d, seed=4)
    tt, ii, tmask, gg = _torch(t, i, mask, g, dtype)
    got = sliced_dt(tt, ii, gg, "nonzero", None)
    assert torch.equal(got, sliced_dt(tt, ii, gg, "nonzero", None, slices=1))
    want, _ = maxsim.maxsim_bwd_plain(tt, ii, gg)
    tol = BWD_TOL[dtype] * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    if dtype == torch.float32:
        fn = lambda a, b: jax_maxsim(a, b, impl="streaming", m_chunk=M)  # noqa: E731
        want_t, _ = _jax_vjp(fn, [t, i], g)
        np.testing.assert_allclose(got.numpy(), want_t, rtol=0,
                                   atol=BWD_TOL[torch.float32] * np.abs(want_t).max())

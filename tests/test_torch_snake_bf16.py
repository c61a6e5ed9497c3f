"""K2-bf16's algebra on the CPU (indextts_tpu_torch/csrc/snake.cu
`snake_bf16_kernel`): the host-side pieces it takes from ops/snake.py (the
banded hi/lo tap matrices and the tiling plan), and a torch emulation of
its whole computation (bfloat16 splits, float32 sums, the snake by the
cosine form, replicate padding and the up signal's edge clamp on a row's
first and last blocks), held against the plain version and against the
JAX package's anti_alias_snake. The kernel itself runs only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

from indextts_tpu_torch.ops import snake as k2  # noqa: E402

# the card's tolerance against the plain version rounded once to bfloat16
ATOL, RTOL = 2e-5, 2.0 ** -7
# (B, C, T) at the kernel's edges: rows that fill no 16-row tile (5, 24, 72
# rows; 15, 16, 17); T below a chunk of 8 and a window of 16; T at a box of
# 64 and one either side; T % 8 = 1..7; T = 1
EDGE_SHAPES = [(1, 5, 100), (1, 24, 1), (1, 24, 2), (1, 24, 7), (1, 24, 15), (1, 24, 16),
               (1, 24, 17), (3, 5, 63), (3, 5, 64), (3, 5, 65), (1, 15, 201), (1, 16, 202),
               (1, 17, 203), (2, 12, 204), (1, 72, 205), (1, 24, 206), (1, 24, 1001),
               (2, 36, 520)]


def _inputs(seed, B, C, T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32)
    return tuple(torch.from_numpy(v).bfloat16() for v in (x, a, b))


def _band():
    """The kernel's eight matrices as float32 (hi, lo) pairs: even, odd,
    left, right."""
    m = torch.from_numpy(k2.band_taps().view(np.int16)).view(torch.bfloat16).float()
    return m.reshape(4, 2, 16, 8)


def _windows(x, n):
    """x (R, T) float32 -> (R, n, 16): window q = x[8q - 8 .. 8q + 7], the
    row replicate-padded (the kernel's padding on the left and right)."""
    R, T = x.shape
    pos = (8 * torch.arange(n)[:, None] - 8 + torch.arange(16)[None, :]).clamp(0, T - 1)
    return x[:, pos]


def emulate(x, alpha, beta, logscale=True, rounded=True):
    """K2-bf16's computation in torch: x (B, C, T) bfloat16; alpha, beta
    (C,) of any float dtype. Output block b (outputs 8b .. 8b+7) from pair
    blocks b and b + 1 (pairs 8q - 4 .. 8q + 3), each from a window of 16
    inputs times the banded matrices, summed in float32; the snake as u +
    h - h cos(2 alpha u); the up signal's edge clamp on the blocks holding a
    pair past either end; P = hi + lo against D = D_hi + D_lo with the
    lo.lo product left out. bfloat16 out where `rounded`, else float32."""
    B, C, T = x.shape
    R, nb = B * C, -(-T // 8)
    band = _band()
    w = _windows(x.reshape(R, T).float(), nb + 1)
    a, bt = alpha.float(), beta.float()
    if logscale:
        a, bt = torch.exp(a), torch.exp(bt)
    rows = torch.arange(R) % C
    a2 = (2.0 * a)[rows][:, None, None]
    h = (0.5 / (bt + 1e-9))[rows][:, None, None]

    def up(i):  # lo first, as the kernel accumulates
        return (w @ band[i, 1]) + (w @ band[i, 0])

    ue, uo = (u + h - h * torch.cos(a2 * u) for u in (up(0), up(1)))
    p = 8 * torch.arange(nb + 1)[:, None] - 4 + torch.arange(8)[None, :]
    first, last = ue[:, 0, 4].clone(), uo.reshape(R, -1)[:, T + 3].clone()
    for u in (ue, uo):
        u[:, p < 0] = first[:, None]
        u[:, p > T - 1] = last[:, None]
    P = torch.cat([ue, uo], -1)
    hi = P.bfloat16().float()
    lo = (P - hi).bfloat16().float()

    def down(blocks, i):
        dh, dl = band[i, 0], band[i, 1]
        return (lo[:, blocks] @ dh) + (hi[:, blocks] @ dl) + (hi[:, blocks] @ dh)

    y = down(slice(0, nb), 2) + down(slice(1, nb + 1), 3)
    y = y.reshape(B, C, nb * 8)[..., :T]
    return y.bfloat16() if rounded else y


def test_band_taps_split_each_tap():
    """hi + lo equals each of the four matrices' taps within 2^-17 of the
    tap; each matrix holds its 6 (up) or 12 (down, 6 a phase) taps on its
    band, every tap of kernel_taps in each column's reach, zeros off it."""
    m = k2.band_matrices()
    band = _band()
    got = (band[:, 0].double() + band[:, 1].double()).numpy()
    assert np.all(np.abs(got - m) <= 2.0 ** -17 * np.abs(m))
    assert np.array_equal(got != 0, m != 0)
    taps = np.array(k2.kernel_taps(), np.float32)
    even, odd, down = taps[:6], taps[6:12], taps[12:]
    for n in range(8):  # every column holds its phase's taps in order
        np.testing.assert_array_equal(m[0, n + 1:n + 7, n], even)
        np.testing.assert_array_equal(m[1, n + 2:n + 8, n], odd)
    # output 8b + n reads up[2t + j - 5], j = 0..11: the down taps appear
    # once each over the left and right blocks
    for n in range(8):
        col = np.concatenate([m[2, :8, n], m[3, :8, n], m[2, 8:, n], m[3, 8:, n]])
        assert sorted(col[col != 0].tolist()) == sorted(down.tolist())


def test_band_fragments_follow_the_mma_layout():
    """band_fragments (the kernel's `Band`) holds each matrix's B fragment
    of mma.m16n8k16 for each lane (g, c): rows 2c, 2c + 1 and 2c + 8,
    2c + 9 of column g, the lower row in the low 16 bits; together the 32
    lanes hold every element of every matrix once."""
    f = k2.band_fragments()
    m = k2.band_taps()
    seen = np.zeros(m.shape, np.int64)
    for lane in range(32):
        g, c = divmod(lane, 4)
        for h in (0, 1):
            for e in (0, 1):
                k = 2 * c + 8 * h + e
                np.testing.assert_array_equal((f[:, lane, h] >> (16 * e)) & 0xFFFF, m[:, k, g])
                seen[:, k, g] += 1
    assert (seen == 1).all()


def test_band_products_are_the_polyphase_firs():
    """The banded products of a random bfloat16 x (windows of 16 inputs
    times hi + lo, in float64) are the plain version's up FIRs (its
    polyphase taps, replicate padding, the gain of 2) for every pair, and
    the down matrices over two pair blocks its down FIR, within 2^-17 of
    the sum of |tap x|."""
    T = 203
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, T))).bfloat16().double()
    band = _band().double()
    full = band[:, 0] + band[:, 1]
    nb = -(-T // 8)
    w = _windows(x, nb + 1)
    even, odd, down = (torch.tensor(t, dtype=torch.float64) for t in k2.polyphase_taps())
    xg = torch.nn.functional.pad(x[None], (8, 8), mode="replicate")[0]
    pairs = 8 * torch.arange(nb + 1)[:, None] - 4 + torch.arange(8)[None, :]
    for i, (taps, off) in enumerate(((even, 3), (odd, 2))):
        got = w @ full[i]
        idx = (pairs[..., None] - off + torch.arange(6) + 8).clamp(0, T + 15)
        terms = 2 * taps * xg[:, idx]
        np.testing.assert_array_less((got - terms.sum(-1)).abs().numpy(),
                                     2.0 ** -17 * terms.abs().sum(-1).numpy() + 1e-300)
    u = torch.randn(3, nb + 1, 16, dtype=torch.float64)
    y = u[:, :nb] @ full[2] + u[:, 1:] @ full[3]
    up = torch.stack([u[..., :8], u[..., 8:]], -1).reshape(3, -1)  # up[2p], up[2p+1]
    t = torch.arange(nb * 8)
    idx = 2 * t[:, None] + torch.arange(12) - 5 + 8  # up index 2p + ph from pair -4
    terms = down * up[:, idx]
    np.testing.assert_array_less((y.reshape(3, -1) - terms.sum(-1)).abs().numpy(),
                                 2.0 ** -17 * terms.abs().sum(-1).numpy())


def _walk(B, C, T, sms):
    """The kernel's loop as index arithmetic (snake_bf16_kernel): per warp,
    the boxes it asks for, the boxes it uses, and each item's chunks and
    output boxes."""
    L, segs, items, blocks = k2.snake_bf16_plan(B, C, T, sms)
    W, box = blocks * k2.SNAKE_BF16_WARPS, k2.SNAKE_BF16_BOX
    R = B * C
    covered = np.zeros((R, T), np.int64)
    for w in range(W):
        asked, used = [], []
        for item in range(w, items, W):
            tile, seg = divmod(item, segs)
            s0 = seg * L
            n_t = min(L, T - s0)
            nsteps, nbox = -(-n_t // 8), -(-n_t // box)
            asked += [(s0 + box * i, 16 * tile) for i in range(nbox)]
            chunks = [s0 // 8 - 1]  # read from global memory
            for c in range(nsteps + 1):
                if c < 8 * nbox:
                    if c % 8 == 0:
                        used.append((s0 + box * (c // 8), 16 * tile))
                    assert used[-1][0] + 8 * (c % 8) == s0 + 8 * c
                chunks.append(s0 // 8 + c)
            # windows q - 1, q for pair blocks k0 .. k0 + nsteps
            assert chunks == list(range(s0 // 8 - 1, s0 // 8 + nsteps + 1))
            for j in range(0, nsteps, 8):  # TMA stores: clipped at T and R
                lo = s0 + 8 * j
                hi = min(s0 + 8 * min(j + 8, nsteps), T)
                covered[16 * tile:16 * tile + 16, lo:hi] += 1
        assert used == asked
    return covered, (L, segs, items, blocks)


@pytest.mark.parametrize("sms", [1, 3, 132])
def test_snake_bf16_plan_covers_each_output_once(sms):
    """K2-bf16's plan with the kernel's index arithmetic stores every
    output of every row once; a warp uses its boxes in the order its lane
    0 asks for them; each item reads the chunks of its windows and no
    other; L a multiple of the box; no block without an item; at the main
    path's shapes of a batched call at least 95 % of the card's warps
    busy."""
    shapes = [(1, 5, 100), (1, 24, 1), (1, 24, 65), (2, 17, 1001), (1, 24, 4098),
              (3, 5, 64), (1, 40, 520)]
    for B, C, T in shapes:
        covered, (L, segs, items, blocks) = _walk(B, C, T, sms)
        assert (covered == 1).all()
        assert L % k2.SNAKE_BF16_BOX == 0 and segs == -(-T // L)
        assert (blocks - 1) * k2.SNAKE_BF16_WARPS < items
        assert blocks <= sms * k2.SNAKE_BF16_BLOCKS
    if sms == 132:
        for C, T in [(2304, 2560), (1152, 10240), (24, 163840)]:
            L, segs, items, blocks = k2.snake_bf16_plan(8, C, T, sms)
            assert items == -(-8 * C // 16) * segs
            assert 0.95 * sms * k2.SNAKE_BF16_BLOCKS <= blocks <= sms * k2.SNAKE_BF16_BLOCKS


@pytest.mark.parametrize("B,C,T", EDGE_SHAPES)
def test_emulation_matches_plain(B, C, T):
    """The emulation within the card test's tolerance of the plain version
    rounded once (|d| <= 2e-5 + 2^-7 |plain|), and before its rounding
    within 2^-15 of max(1, |plain|) of the plain version in float32."""
    x, a, b = _inputs(T, B, C, T)
    for ab in ((a, b), (a.float(), b.float())):
        want = k2.anti_alias_snake_plain(x.float(), ab[0].float(), ab[1].float(), True)
        got = emulate(x, *ab, rounded=False)
        assert ((got - want).abs() <= 2.0 ** -15 * want.abs().clamp_min(1.0)).all()
        d = (emulate(x, *ab).float() - want.bfloat16().float()).abs()
        assert (d <= ATOL + RTOL * want.bfloat16().float().abs()).all()


@pytest.mark.parametrize("logscale", [True, False])
def test_emulation_matches_plain_small_beta(logscale):
    """The same with beta = exp(-4) on every fourth channel and without
    logscale. 1 / beta = 55 lifts the up signal to ~55, whose split hi + lo
    keeps 2^-17 of it, and the down FIR's sum can cancel to below 1: before
    rounding, the emulation is held within 2^-15 of its row's largest
    |plain| (at least 1)."""
    x, a, b = _inputs(7, 2, 24, 517)
    if not logscale:
        a, b = a.float().abs() + 0.5, b.float().abs() + 0.5
    b = b.float().clone()
    b[::4] = -4.0 if logscale else float(np.exp(-4.0))
    want = k2.anti_alias_snake_plain(x.float(), a.float(), b, logscale)
    got = emulate(x, a, b, logscale, rounded=False)
    top = want.abs().amax(-1, keepdim=True).clamp_min(1.0)
    assert ((got - want).abs() <= 2.0 ** -15 * top).all()
    d = (emulate(x, a, b, logscale).float() - want.bfloat16().float()).abs()
    assert (d <= ATOL + RTOL * want.bfloat16().float().abs()).all()


@pytest.mark.parametrize("B,C,T", [(1, 5, 100), (2, 24, 65), (1, 17, 203), (1, 24, 7)])
def test_emulation_matches_jax(B, C, T):
    """The emulation against JAX anti_alias_snake on the same bfloat16
    numpy inputs, computed in float32 (its sliced form at B = 1, its conv
    form past it), both rounded once: within the card's tolerance."""
    from indextts_tpu.ops.snake import anti_alias_snake as janti

    x, a, b = _inputs(B * T, B, C, T)
    args = [jnp.asarray(v.float().numpy()) for v in (x, a, b)]
    want = np.asarray(janti(jnp.swapaxes(args[0], 1, 2), args[1], args[2], True))
    want = torch.from_numpy(want.transpose(0, 2, 1).copy()).bfloat16().float()
    d = (emulate(x, a, b).float() - want).abs()
    assert (d <= ATOL + RTOL * want.abs()).all()

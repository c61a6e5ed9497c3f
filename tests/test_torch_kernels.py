"""The port's kernel modules against the JAX package.

Each plain PyTorch version (what the port's wrappers run for CPU tensors)
is held against the JAX function it replaces, run as the JAX package's own
tests run it on the CPU: Pallas kernels in interpret mode, and the XLA
paths beside them. tests/test_torch_cuda.py compares each CUDA kernel with
its plain version on a GPU.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

from indextts_tpu_torch.ops import decode_attention as k1  # noqa: E402
from indextts_tpu_torch.ops import dit_attention as k3  # noqa: E402
from indextts_tpu_torch.ops import snake as k2  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K1: ragged decode attention with a hole
# ---------------------------------------------------------------------------


def _decode_inputs(rng, B, H, cap, Dh):
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, H, cap, Dh)).astype(np.float32)
    v = rng.standard_normal((B, H, cap, Dh)).astype(np.float32)
    return q, k, v


def _k1_plain(q, k, v, valid, hs=None, he=None):
    B = q.shape[0]
    hs = np.zeros(B, np.int32) if hs is None else np.asarray(hs, np.int32)
    he = np.zeros(B, np.int32) if he is None else np.asarray(he, np.int32)
    return k1.ragged_decode_attention(
        _t(q), _t(k), _t(v), _t(np.asarray(valid, np.int32)), _t(hs), _t(he)
    ).numpy()


@pytest.mark.parametrize("valid,holes", [
    ([100, 512, 257], None),
    ([512, 1, 128], None),
    ([512, 1, 384], ([34, 0, 40], [60, 0, 90])),
])
def test_k1_plain_matches_pallas_transposed(rng, valid, holes):
    """Against the kernel GPT2Attention calls with attn_impl=pallas_ragged
    (transposed cache). Tolerance: fp32 online vs one-shot softmax, 2e-5."""
    from indextts_tpu.ops.decode_attention import ragged_decode_attention_t

    q, k, v = _decode_inputs(rng, 3, 4, 512, 64)
    hs, he = (None, None) if holes is None else holes
    want = np.asarray(ragged_decode_attention_t(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)),
        jnp.asarray(v.transpose(0, 1, 3, 2)), jnp.asarray(valid, jnp.int32),
        blk=128, interpret=True,
        hole_start=None if hs is None else jnp.asarray(hs, jnp.int32),
        hole_end=None if he is None else jnp.asarray(he, jnp.int32),
    ))
    got = _k1_plain(q, k, v, valid, hs, he)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("valid", [[100, 512, 257], [1, 3, 512], [512, 512, 512]])
def test_k1_plain_matches_xla_reference(rng, valid):
    """Against the package's XLA oracle (no hole), the cases of
    tests/test_decode_attention.py. Tolerance 2e-5 (fp32 reductions)."""
    from indextts_tpu.ops.decode_attention import ragged_decode_attention_xla

    q, k, v = _decode_inputs(rng, 3, 4, 512, 64)
    want = np.asarray(ragged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid, jnp.int32)))
    np.testing.assert_allclose(_k1_plain(q, k, v, valid), want, atol=2e-5, rtol=1e-4)


def test_k1_plain_hole_matches_xla_with_hole(rng):
    """The q8 oracle's mask logic on a float cache (dequantization is the
    identity here): keys in [hole_s, hole_e) are excluded."""
    q, k, v = _decode_inputs(rng, 2, 3, 256, 64)
    vl, hs, he = np.array([200, 256]), np.array([10, 0]), np.array([50, 0])
    s = np.einsum("bhd,bhsd->bhs", q, k) / np.sqrt(64)
    pos = np.arange(256)
    ok = (pos[None] < vl[:, None]) & ~((pos[None] >= hs[:, None]) & (pos[None] < he[:, None]))
    s = np.where(ok[:, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhs,bhsd->bhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(_k1_plain(q, k, v, vl, hs, he), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("valid,holes", [
    ([100, 512, 257], None),
    ([512, 1, 128], None),
    ([200, 256, 100], ([10, 0, 0], [50, 0, 0])),
])
def test_k1_plain_matches_pallas_blocked(rng, valid, holes):
    """Against the block-major Pallas kernel (interpret), with and without
    the hole. Tolerance as above."""
    from indextts_tpu.ops.decode_attention import (
        ragged_decode_attention_blocked,
        to_blocked_cache,
    )

    q, k, v = _decode_inputs(rng, 3, 4, 512, 64)
    hs, he = (None, None) if holes is None else holes
    want = np.asarray(ragged_decode_attention_blocked(
        jnp.asarray(q), to_blocked_cache(jnp.asarray(k), 128),
        to_blocked_cache(jnp.asarray(v), 128), jnp.asarray(valid, jnp.int32),
        interpret=True,
        hole_start=None if hs is None else jnp.asarray(hs, jnp.int32),
        hole_end=None if he is None else jnp.asarray(he, jnp.int32)))
    np.testing.assert_allclose(_k1_plain(q, k, v, valid, hs, he), want,
                               atol=2e-5, rtol=1e-4)


def test_k1_plain_bf16_cache(rng):
    """bf16 cache, as the JAX bf16 test: both read the same bf16 values and
    accumulate in fp32 (tolerance 5e-3 as there)."""
    from indextts_tpu.ops.decode_attention import ragged_decode_attention_xla

    q, k, v = _decode_inputs(rng, 2, 2, 256, 64)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    want = np.asarray(ragged_decode_attention_xla(
        jnp.asarray(q), jnp.asarray(kb.float().numpy(), jnp.bfloat16),
        jnp.asarray(vb.float().numpy(), jnp.bfloat16), jnp.asarray([100, 256], jnp.int32)))
    zero = torch.zeros(2, dtype=torch.int32)
    got = k1.ragged_decode_attention(_t(q), kb, vb, torch.tensor([100, 256], dtype=torch.int32),
                                     zero, zero).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-2)


@pytest.mark.parametrize("row_bytes", [256, 128, 64])
def test_k1_k4_split_covers_every_valid_key_once(row_bytes):
    """The kernels' split of [0, min(valid, cap)) over a cluster's ranks
    (rank_span, which csrc/decode_attention.cu computes on the device) and
    their rounds (round_keys, fp32/bf16/int8 rows): every key once, each
    share starting on a 16-key chunk and ending inside the cache, the
    rounds within the block's threads and shared memory, and at the default
    config's cap (1657) a whole share in one round."""
    for cap in (1, 15, 16, 17, 127, 128, 129, 383, 1000, 1657, 1664, 1665, 3000):
        rk = k1.round_keys(cap, row_bytes)
        assert rk % k1.CHUNK == 0 and 0 < rk <= k1.THREADS
        assert 2 * rk * row_bytes <= k1.ROUND_KV_BYTES
        for valid in range(cap + 3):
            seen = np.zeros(cap + 3, np.int64)
            for rank in range(k1.CLUSTER):
                start, end = k1.rank_span(valid, cap, rank)
                assert 0 <= start <= end <= min(valid, cap)
                assert start == end or start % k1.CHUNK == 0
                seen[start:end] += 1
            n = min(valid, cap)
            assert (seen[:n] == 1).all() and not seen[n:].any()
    for row_bytes_, cap in ((256, 1657), (128, 1657), (64, 1657), (64, 2048)):
        assert k1.round_keys(cap, row_bytes_) >= k1.rank_span(cap, cap, 0)[1]


# ---------------------------------------------------------------------------
# K2: fused anti-aliased SnakeBeta
# ---------------------------------------------------------------------------


def _snake_inputs(rng, B, T, C):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    a = (rng.standard_normal(C) * 0.3).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32)
    return x, a, b


def _k2_plain(x_btc, a, b, logscale=True):
    out = k2.anti_alias_snake(_t(x_btc.transpose(0, 2, 1)), _t(a), _t(b), logscale)
    return out.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("T,C,bt", [(300, 16, 128), (1024, 8, 256), (37, 8, 64),
                                    (256, 192, 128), (300, 96, 256)])
def test_k2_plain_matches_pallas(rng, T, C, bt):
    """Against the channels-on-lanes Pallas kernel (interpret). 2e-6 as the
    JAX kernel tests: same polyphase algebra, same order."""
    from indextts_tpu.ops.snake_pallas import anti_alias_snake_pallas

    x, a, b = _snake_inputs(rng, 2, T, C)
    want = np.asarray(anti_alias_snake_pallas(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), True, block_t=bt, interpret=True))
    np.testing.assert_allclose(_k2_plain(x, a, b), want, atol=2e-6)


@pytest.mark.parametrize("T,C,bt", [(2048, 24, 512), (700, 48, 256), (300, 96, 128),
                                    (37, 12, 128), (1024, 192, 256)])
def test_k2_plain_matches_pallas_t(rng, T, C, bt):
    """Against the time-on-lanes Pallas kernel (interpret)."""
    from indextts_tpu.ops.snake_pallas import anti_alias_snake_pallas_t

    x, a, b = _snake_inputs(rng, 2, T, C)
    want = np.asarray(anti_alias_snake_pallas_t(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), True, block_t=bt, interpret=True))
    np.testing.assert_allclose(_k2_plain(x, a, b), want, atol=2e-6)


@pytest.mark.parametrize("logscale", [True, False])
def test_k2_plain_matches_sliced_and_conv(rng, logscale):
    """Against anti_alias_snake_sliced (the algebra the plain version
    copies) and the depthwise-conv reference path up2 -> snake -> down2."""
    from indextts_tpu.ops.snake import (
        anti_alias_snake_sliced,
        downsample2,
        snake_beta,
        upsample2,
    )

    x, a, b = _snake_inputs(rng, 2, 200, 24)
    if not logscale:
        a, b = np.abs(a) + 0.5, np.abs(b) + 0.5
    got = _k2_plain(x, a, b, logscale)
    sliced = np.asarray(anti_alias_snake_sliced(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), logscale))
    np.testing.assert_allclose(got, sliced, atol=2e-6)
    conv = np.asarray(downsample2(snake_beta(
        upsample2(jnp.asarray(x)), jnp.asarray(a), jnp.asarray(b), logscale)))
    np.testing.assert_allclose(got, conv, atol=1e-5)


def test_k2_filter_matches_jax():
    from indextts_tpu.ops.snake import _aa_filter

    np.testing.assert_array_equal(k2.kaiser_sinc_filter1d(0.25, 0.3, 12), _aa_filter(2, 12))


def _vocoder_snake_shapes():
    """(B, C, T) of every K2 launch of a vocoder call at the main path's
    shapes (chip_smoke.py `main_path_shapes`, max_mel_tokens 300)."""
    import chip_smoke

    from indextts_tpu_torch.config import load_config

    seq = chip_smoke.main_path_shapes(load_config(), chip_smoke.MAX_MEL_TOKENS)["snake"]
    return [(1, C, T) for C, T in dict.fromkeys(seq)]


@pytest.mark.parametrize("shapes", ["main path", "T=1..40", "T%4!=0 and edges"])
def test_snake_plan_covers_each_output_once(shapes):
    """K2's plan (snake_plan) with the kernel's own index arithmetic puts
    every output of every row in exactly one lane, and each row's chunks
    in one warp each; warps past the rows only in the last block; a block
    for every one of the H100's 132 SMs at the main path's shapes."""
    if shapes == "main path":
        cases = _vocoder_snake_shapes()
        assert len(cases) == 7
    elif shapes == "T=1..40":
        cases = [(2, 3, t) for t in range(1, 41)]
    else:
        r, w = k2.SNAKE_LANE_OUTPUTS, k2.SNAKE_WARPS
        cases = [(1, 5, 1001), (2, 7, 2063), (1, 3, 4098), (1, 5, 100)]
        cases += [(1, 3, 32 * r * n + d) for n in (1, w) for d in (-1, 0, 1)]
    for B, C, T in cases:
        r, chunks, blocks = k2.snake_plan(B, C, T)
        per = 32 * r
        assert chunks == -(-T // per) and (chunks - 1) * per < T
        # warp w = block * SNAKE_WARPS + warp index; those past the rows return
        w = np.arange(blocks * k2.SNAKE_WARPS)
        live = w < B * C * chunks
        assert live[:(blocks - 1) * k2.SNAKE_WARPS].all()
        row, chunk = w[live] // chunks, w[live] % chunks
        np.testing.assert_array_equal(np.bincount(row * chunks + chunk), np.ones(B * C * chunks))
        # warp chunk, lane l, register i -> output chunk * 32R + l * R + i
        t = (np.arange(chunks)[:, None, None] * per + np.arange(32)[None, :, None] * r
             + np.arange(r)[None, None, :]).ravel()
        np.testing.assert_array_equal(np.bincount(t[t < T], minlength=T), np.ones(T))
        if shapes == "main path":
            assert blocks >= 132


def test_kernel_taps_fold_the_gain_exactly():
    """The kernel's even and odd taps are 2 x the polyphase taps exactly in
    float32, and an up FIR summed in the plain version's order with them
    gives 2 x the FIR with the plain taps, to the bit."""
    even, odd, down = k2.polyphase_taps()
    taps = np.array(k2.kernel_taps(), np.float32)
    plain = np.array(even + odd, np.float32)
    np.testing.assert_array_equal(taps[:12], 2 * plain)
    np.testing.assert_array_equal(taps[12:], np.array(down, np.float32))
    x = np.random.default_rng(0).standard_normal((6, 4096)).astype(np.float32) * 3

    def fir(t):
        acc = t[0] * x[0]
        for m in range(1, 6):
            acc = acc + t[m] * x[m]
        return acc

    for phase in (slice(0, 6), slice(6, 12)):
        np.testing.assert_array_equal(fir(taps[phase]), np.float32(2) * fir(plain[phase]))


# ---------------------------------------------------------------------------
# K3: DiT attention with a key-padding mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,lens", [(40, [40, 23]), (300, [300, 1])])
def test_k3_plain_matches_dit_attention_xla(rng, T, lens):
    """Against DiTAttention's XLA path (the CPU path of the JAX package),
    partial key masks included. Tolerance 1e-5: fp32 einsum + softmax."""
    import jax
    from indextts_tpu.config import DiTConfig
    from indextts_tpu.models.s2mel import DiTAttention as JDiTAttention
    from indextts_tpu.models.s2mel import precompute_rope

    from indextts_tpu_torch.models.s2mel import DiTAttention

    cfg = DiTConfig(hidden_dim=64, num_heads=4)
    B = len(lens)
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    valid = np.arange(T)[None] < np.asarray(lens)[:, None]
    rope = precompute_rope(T, cfg.head_dim, cfg.rope_base)
    jm = JDiTAttention(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(rope),
                     jnp.asarray(valid[:, None, None, :]))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(rope),
                               jnp.asarray(valid[:, None, None, :])))
    tm = DiTAttention(cfg)
    p = params["params"]
    tm.wqkv.weight.data = _t(np.asarray(p["wqkv"]["kernel"]).T.copy())
    tm.wo.weight.data = _t(np.asarray(p["wo"]["kernel"]).T.copy())
    with torch.no_grad():
        got = tm(_t(x), _t(rope), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_k3_plain_fully_masked_rows_stay_finite(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
               for _ in range(3))
    out = k3.dit_attention(q, k, v, torch.zeros((1, 8), dtype=torch.bool))
    assert torch.isfinite(out).all()


def _masked_row(pattern, T):
    """A (T,) bool key row: "head" masks the first 64 keys (a whole leading
    tile of K3-bf16's at 64 keys, half of one at 128), "run" a 64-key run
    between valid keys and every fifth key of a second stretch, "none"
    every key."""
    j = np.arange(T)
    if pattern == "head":
        return j >= 64
    if pattern == "run":
        return ~(((j >= 64) & (j < 128)) | ((j >= 150) & (j % 5 == 2)))
    return np.zeros(T, bool)


@pytest.mark.parametrize("pattern", ["head", "run", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_matches_xla_math_at_skipped_tiles(rng, dtype, pattern):
    """`dit_attention_plain`, which the card holds K3 and K3-bf16 to,
    against the JAX XLA attention math (indextts_tpu/models/s2mel.py
    `DiTAttention.__call__`, its non-flash branch) on the same numpy draws
    at T=200, at the masks whose key tiles the kernels skip: a masked
    first tile, a masked run between valid keys, and a row with no valid
    key (beside a row of all valid keys). Tolerance: float32 1e-5 (einsum
    and softmax in another order); bfloat16 2^-8 of max|out| (both round
    the scores, the probabilities and the output to bfloat16, at times on
    either side of a rounding boundary)."""
    import jax

    from indextts_tpu.models.s2mel import NEG_INF

    T, H, Dh = 200, 2, 64
    q, k, v = (rng.standard_normal((2, H, T, Dh)).astype(np.float32) for _ in range(3))
    mask = np.stack([_masked_row(pattern, T), np.ones(T, bool)])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x, dtype=jdt) for x in (q, k, v))
    scores = jnp.einsum("bhtd,bhsd->bhts", jq, jk) / math.sqrt(Dh)
    scores = jnp.where(jnp.asarray(mask)[:, None, None, :], scores, NEG_INF)
    probs = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(jv.dtype)
    want = np.asarray(jnp.einsum("bhts,bhsd->bhtd", probs, jv).astype(jnp.float32))
    got = k3.dit_attention_plain(*(_t(x).to(tdt) for x in (q, k, v)), _t(mask)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= 2 ** -8 * np.abs(want).max()
    if pattern == "none":  # the row with no valid key averages v over all T keys
        mean = _t(v[0]).to(tdt).float().numpy().mean(axis=1, keepdims=True)
        np.testing.assert_allclose(got[0], np.broadcast_to(mean, got[0].shape),
                                   atol=1e-5 if dtype == "float32" else 1e-3)


# ---------------------------------------------------------------------------
# K6 / K8: the hidden's group scale
# ---------------------------------------------------------------------------


# maxima whose max / 127 and max * (1/127) round apart in float32
_SCALE_SPLITS = (13, 18, 26, 36, 52, 72, 104)


@pytest.mark.parametrize("w4", [False, True])
def test_mlp_group_scale_is_a_true_quotient(w4):
    """The JAX MLP kernels (Pallas, interpret mode) scale a hidden group by
    max|h| / 127, correctly rounded, not by max|h| times the float
    reciprocal of 127, and the port's plain versions (the CPU path of
    mlp_w8 / mlp_w4) give the same bits. The input makes the scale readable
    in the output: row r's hidden is m_r at one-hot weights of 1, 0 at 0
    and gelu_new(-m_r) = 0 at -1, with m_r >= 13 where tanh is exactly 1
    and gelu_new exact; so hq is 127 or 0, and with unit scales and no
    biases out = fl(acc2 * ha_r), which tells the two scales apart for each
    m_r in _SCALE_SPLITS."""
    from indextts_tpu.ops import gemv as jgemv
    from indextts_tpu_torch.ops import gemv as gemv_ops

    rng = np.random.default_rng(5)
    b, d = 16, 256 if w4 else 128
    fh = 4 * d
    m = np.array([_SCALE_SPLITS[r % len(_SCALE_SPLITS)] for r in range(b)], np.int32)
    xq = np.zeros((b, d), np.int8)
    xq[np.arange(b), np.arange(b)] = m
    fc = rng.integers(-1, 2, (d, fh)).astype(np.int8)
    fc[:b, 0] = 1
    lim = 8 if w4 else 128
    fc2 = rng.integers(-lim, lim, (fh, d)).astype(np.int8)
    ones, zeros = np.ones(fh, np.float32), np.zeros(fh, np.float32)
    vecs = (ones, zeros, np.ones(d, np.float32), np.zeros(d, np.float32))
    a = np.ones(b, np.float32)
    if w4:
        fc_w = gemv_ops.pack_w4(torch.from_numpy(fc)).numpy()
        fc2_w = gemv_ops.pack_w4(torch.from_numpy(fc2), cols=True).numpy()
        jax_mlp, port_mlp = jgemv.mlp_w4, gemv_ops.mlp_w4
        assert gemv_ops.mlp_group_w4(d, fh) == fh
    else:
        fc_w, fc2_w = fc, fc2
        jax_mlp, port_mlp = jgemv.mlp_w8, gemv_ops.mlp_w8
        assert gemv_ops.mlp_group(d, fh) == fh
    ws = (fc_w, vecs[0], vecs[1], fc2_w, vecs[2], vecs[3])
    got = np.asarray(jax_mlp(jnp.asarray(xq), jnp.asarray(a), *map(jnp.asarray, ws),
                             interpret=True))

    hq = np.where(fc[:b] == 1, 127, 0).astype(np.int64)  # row r, one-hot row r
    acc2 = (hq @ fc2.astype(np.int64)).astype(np.float32)
    mf = m.astype(np.float32)[:, None]
    product = mf * (np.float32(1) / np.float32(127)) + np.float32(1e-12)
    quotient = mf / np.float32(127) + np.float32(1e-12)
    assert not np.array_equal(acc2 * quotient, acc2 * product)
    np.testing.assert_array_equal(got, acc2 * quotient)
    port = port_mlp(*(torch.from_numpy(v) for v in (xq, a, *ws))).numpy()
    np.testing.assert_array_equal(port, got)


# ---------------------------------------------------------------------------
# K5-K8: decode rows past one launch's limit, in chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["gemv_w8", "gemv_w4", "mlp_w8", "mlp_w4"])
@pytest.mark.parametrize("rows,chunk", [(17, 16), (40, 16), (40, 7)])
def test_row_chunks_give_one_calls_bits(fn, rows, chunk):
    """`by_row_chunks` (how the wrappers split rows past a launch's limit)
    over the plain versions gives one call's result to the bit: each row's
    scale and hidden groups are its own."""
    from indextts_tpu_torch.models.gpt2 import quant_row, quantize_weight, quantize_weight_w4
    from indextts_tpu_torch.ops import gemv as gemv_ops

    g = torch.Generator().manual_seed(rows + chunk)
    d = 256
    xq, a = quant_row(torch.randn((rows, d), generator=g))

    def weight(di, f, cols=False):
        w = torch.randn((di, f), generator=g) / di ** 0.5
        w_q, s = quantize_weight_w4(w, cols) if fn.endswith("w4") else quantize_weight(w)
        return w_q, s, torch.randn((f,), generator=g) * 0.1

    if fn.startswith("gemv"):
        ws = weight(d, 384)
    else:
        ws = weight(d, 4 * d) + weight(4 * d, d, cols=True)
    plain = getattr(gemv_ops, f"{fn}_plain")
    got = gemv_ops.by_row_chunks(plain, chunk, xq, a, *ws)
    assert torch.equal(got, plain(xq, a, *ws))

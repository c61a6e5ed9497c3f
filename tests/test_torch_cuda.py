"""Each CUDA kernel of the port against its plain PyTorch version, on a GPU.

Skips without one. Imports nothing of JAX, so it also runs where only the
port is installed: `python -m pytest --noconftest tests/test_torch_cuda.py`
(the repository's conftest imports JAX). Tolerances: fp32 online softmax
against a one-shot softmax (K1; K3 also within 2e-5 absolute, in 3xTF32
on the tensor cores); the same fp32 algebra with the kernel's
sine, expf and FMA contraction (K2); K2-bf16 (both FIRs on the tensor cores,
float32-class sums) within one bfloat16 step of the plain version rounded
once; for K4 as for K1 over an int8 cache, 1e-5; K5
to K8 exact int32 sums with the plain versions' float32 operations in the
same order, so their results agree to the last bit (K7 is held to that) or
within one unit of it (1e-6 of max|out| is allowed); K9 and K10 (K3's
backward) within 2e-5 of max(1, max|plain|) of autograd through the plain
attention, and one training step on the card against the CPU's (`-k
train`).
"""

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from indextts_tpu_torch.ops import cuda_lib
from indextts_tpu_torch.ops import decode_attention as k1
from indextts_tpu_torch.ops import dit_attention as k3
from indextts_tpu_torch.ops import gemv
from indextts_tpu_torch.ops import snake as k2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (B, cap, valid, hole start, hole end): a ragged pair with a hole; three
# rows at the main path's cap (383) and the default config's (1657); then
# the edges of K1/K4's split, where a cluster rank takes a share of
# 16 * ceil(valid / 128) keys (decode_attention.rank_span): valids at and
# across the edges of a 16-key chunk and of a share; unequal rows; a hole
# across the rank boundaries at 128 and 256; a hole over every key but one;
# shares past one round of the block's copies (cap 3000); mid-decode steps
# at cap 1657; a continuous batch's slot state at full width (8 rows of
# 157-key prompts in a cache of 512: unequal valid lengths, holes from the
# conditioning's end at 34, one row without a hole, an idle row on one key)
DECODE_CASES = [
    (2, 700, [650, 1], [40, 0], [90, 0]),
    (3, 383, [383, 191, 1], [40, 3, 0], [90, 9, 0]),
    (3, 1657, [1657, 828, 1], [40, 3, 0], [90, 9, 0]),
    (7, 300, [1, 2, 15, 16, 17, 127, 129], [0] * 7, [0] * 7),
    (3, 700, [700, 333, 1], [0, 40, 0], [0, 90, 0]),
    (1, 1000, [1000], [100], [300]),
    (2, 500, [500, 500], [0, 1], [499, 500]),
    (2, 3000, [3000, 2100], [0, 50], [0, 60]),
    (2, 1657, [400, 1000], [0, 0], [0, 0]),
    (8, 512, [457, 411, 350, 298, 233, 190, 158, 1], [0] + [34] * 7,
     [0, 39, 51, 74, 97, 124, 152, 59]),
]


def _decode_ints(dev, vl, hs, he):
    return tuple(torch.tensor(a, dtype=torch.int32, device=dev) for a in (vl, hs, he))


def _k1_args(dev, B, cap, dtype, ints):
    g = torch.Generator(device=dev).manual_seed(cap)
    q = torch.randn((B, 20, 64), generator=g, device=dev)
    k, v = (torch.randn((B, 20, cap, 64), generator=g, device=dev).to(dtype) for _ in range(2))
    return (q, k, v, *ints)


def _k4_args(dev, B, cap, ints):
    from indextts_tpu_torch.models.gpt2 import quantize_kv

    g = torch.Generator(device=dev).manual_seed(cap)
    q = torch.randn((B, 20, 64), generator=g, device=dev)
    k8, ksc = quantize_kv(torch.randn((B, 20, cap, 64), generator=g, device=dev))
    v8, vsc = quantize_kv(torch.randn((B, 20, cap, 64), generator=g, device=dev))
    return (q, k8, v8, ksc, vsc, *ints)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,cap,vl,hs,he", DECODE_CASES)
def test_k1_cuda_matches_plain(cuda_device, dtype, B, cap, vl, hs, he):
    """Within 2e-5 of the plain version: fp32 softmax over 8 ranks' shares
    against a one-shot softmax, |out| ~ 1."""
    args = _k1_args(cuda_device, B, cap, dtype, _decode_ints(cuda_device, vl, hs, he))
    got = k1.ragged_decode_attention(*args)
    want = k1.ragged_decode_attention_plain(*args)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert (got - want).abs().max() <= 2e-5


@pytest.mark.cuda
def test_k1_cuda_row_without_keys_is_zero(cuda_device):
    ints = _decode_ints(cuda_device, [0, 10, 40], [0, 0, 0], [0, 9, 40])
    got = k1.ragged_decode_attention(*_k1_args(cuda_device, 3, 64, torch.float32, ints))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert got[1].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_attention_graph_replay_repeats_its_bits(cuda_device, cache):
    """K1 (float32, bfloat16) and K4 (int8) replayed from a CUDA graph give
    the eager call's bits: one launch, no scratch, a fixed order of sums."""
    ints = _decode_ints(cuda_device, [383, 200], [0, 20], [0, 50])
    if cache == "int8":
        args = _k4_args(cuda_device, 2, 383, ints)
        fn = lambda: k1.ragged_decode_attention_q8(*args)  # noqa: E731
    else:
        args = _k1_args(cuda_device, 2, 383, getattr(torch, cache), ints)
        fn = lambda: k1.ragged_decode_attention(*args)  # noqa: E731
    want = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert torch.equal(fn(), want)


# K2's cases (B, C, T, logscale, small_beta): the three checked before
# the plan (their inputs drawn as then, from seed 0); from the plan
# (snake.snake_plan: a warp takes 32 * R outputs of a row, lane l the R
# from l * R): rows shorter than a lane's R; T at a warp's chunk and at a
# block's four chunks and one either side; a last chunk of one lane; a
# chunk whose input halo reaches past a short last chunk; T % 4 != 0
# (scalar loads); logscale False; a grid whose last block holds one warp;
# the main path's first two vocoder stages; beta = exp(-4) on every fourth
# channel, where 1 / beta scales the sine's error 55-fold
_CHUNK = 32 * k2.SNAKE_LANE_OUTPUTS
_BLOCK = _CHUNK * k2.SNAKE_WARPS
K2_CASES = [
    (1, 24, 37, True, False), (1, 72, 1000, True, False), (1, 2304, 513, True, False),
    *[(1, 24, t, True, False) for t in (1, 2, 3, 7, _CHUNK - 1, _CHUNK, _CHUNK + 1)],
    *[(2, 9, t, True, False) for t in (_BLOCK - 1, _BLOCK, _BLOCK + 1)],
    (1, 24, 2 * _CHUNK + k2.SNAKE_LANE_OUTPUTS, True, False),
    (1, 24, 2 * _CHUNK + 3, True, False),
    (1, 72, 1001, True, False), (1, 144, 2063, True, False), (2, 30, 4098, True, False),
    (1, 72, 1000, False, False), (2, 24, 517, False, False), (1, 5, 100, True, False),
    (1, 2304, 2064, True, False), (1, 1152, 8256, True, False),
    (2, 72, 1000, True, True), (1, 2304, 2064, True, True), (2, 24, 517, False, True),
]


def _k2_inputs(dev, B, C, T, logscale, small_beta=False):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, C, T), generator=g, device=dev)
    a = torch.randn((C,), generator=g, device=dev) * 0.3
    b = torch.randn((C,), generator=g, device=dev) * 0.3
    if not logscale:
        a, b = a.abs() + 0.5, b.abs() + 0.5
    if small_beta:
        b[::4] = -4.0 if logscale else math.exp(-4.0)
    return x, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T,logscale,small_beta", K2_CASES)
def test_k2_cuda_matches_plain(cuda_device, B, C, T, logscale, small_beta):
    x, a, b = _k2_inputs(cuda_device, B, C, T, logscale, small_beta)
    got = k2.anti_alias_snake(x, a, b, logscale)
    torch.testing.assert_close(got, k2.anti_alias_snake_plain(x, a, b, logscale),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_k2_cuda_replays_its_bits(cuda_device):
    """Two more calls and two replays of a CUDA graph of one call give the
    first call's bits: one launch, no scratch, a fixed order of sums."""
    x, a, b = _k2_inputs(cuda_device, 1, 2304, 2064, True)
    want = k2.anti_alias_snake(x, a, b, True)
    assert all(torch.equal(k2.anti_alias_snake(x, a, b, True), want) for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.anti_alias_snake(x, a, b, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k2.anti_alias_snake(x, a, b, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


# K2-bf16 at the main path's vocoder shapes (the mel at the s2mel bucket's
# 640 frames: its first and last stages) and the longest segment's, at one
# row and at a batched call's 8, and edge cases: T % 4 != 0, a short row;
# then the edges of its tiling (snake.snake_bf16_plan: tiles of 16 rows,
# segments of L outputs a multiple of the 64-position TMA box, chunks of
# 8): T = 1, 2, 15-17 about a window of 16, 63-65 about a box; 5, 15, 17
# and 24 rows; T % 8 = 3..6 (the kernel without TMA); rows whose last
# segment ends one short of a box (T = 2303, 3071). Its float32-class arithmetic and
# the plain version's (which widens, computes and rounds once) differ by
# one bfloat16 step where they straddle a rounding boundary: atol 2e-5,
# rtol 2^-7.
K2_BF16_CASES = [(1, 2304, 2560), (8, 2304, 2560), (1, 24, 163840), (1, 2304, 10752),
                 (1, 24, 688128), (1, 24, 37), (2, 72, 1001), (1, 144, 2063),
                 (1, 24, 1), (1, 24, 2), (1, 24, 15), (1, 24, 16), (1, 24, 17), (3, 5, 63),
                 (3, 5, 64), (3, 5, 65), (1, 15, 201), (1, 17, 203), (2, 12, 205),
                 (1, 24, 206), (1, 5, 100), (1, 72, 2303), (1, 72, 3071)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,T", K2_BF16_CASES)
def test_k2_bf16_cuda_matches_plain(cuda_device, B, C, T):
    x, a, b = _k2_inputs(cuda_device, B, C, T, True)
    x, a, b = x.bfloat16(), a.bfloat16(), b.bfloat16()
    counted = k2.bf16_counter.launches, k2.counter.launches
    got = k2.anti_alias_snake(x, a, b, True)
    assert got.dtype == torch.bfloat16
    assert (k2.bf16_counter.launches, k2.counter.launches) == (counted[0] + 1, counted[1])
    want = k2.anti_alias_snake_plain(x.float(), a.float(), b.float(), True)
    torch.testing.assert_close(got.float(), want.bfloat16().float(), atol=2e-5, rtol=2 ** -7)


@pytest.mark.cuda
def test_k2_bf16_cuda_replays_its_bits(cuda_device):
    """K2-bf16 at the main path's first shape: two more calls and two
    replays of a CUDA graph of one call give the first call's bits (one
    launch, no scratch, a fixed order of sums), and it spills nothing."""
    x, a, b = (t.bfloat16() for t in _k2_inputs(cuda_device, 1, 2304, 2560, True))
    want = k2.anti_alias_snake(x, a, b, True)
    assert all(torch.equal(k2.anti_alias_snake(x, a, b, True), want) for _ in range(2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2.anti_alias_snake(x, a, b, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k2.anti_alias_snake(x, a, b, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert all(local == 0 for _, local in k2.bf16_attributes().values())


def _masked_head_row(dev, T):
    """Keys whose valid ones are no prefix, cut at K3-bf16's 128-key tiles:
    the first 128 masked, a masked 128-key run (384-511) between valid
    keys, every seventh key of 640-767 and the last five masked."""
    j = torch.arange(T, device=dev)
    return ~((j < 128) | ((j >= 384) & (j < 512)) | ((j >= 640) & (j < 768) & (j % 7 == 3))
             | (j >= T - 5))


def _k3_inputs(dev, T, lens):
    """q, k, v (len(lens), 8, T, 64) float32 and the key mask: a row n
    valid keys for an int n, `_masked_head_row` for "masked-head"."""
    g = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn((len(lens), 8, T, 64), generator=g, device=dev) for _ in range(3))
    j = torch.arange(T, device=dev)
    mask = torch.stack([_masked_head_row(dev, T) if r == "masked-head" else j < r for r in lens])
    return q, k, v, mask


# (T, valid keys per batch row): partial masks at T=100 and 300; T=37, below
# one 64-key tile; T=774, the main path's (chip_smoke.py); T=2838, the
# longest the default config allows (max_mel_tokens 1500); a row with one
# valid key; a row with no valid key, which averages v over all T keys
@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [(100, [100, 50]), (300, [300, 150]), (37, [37, 20]),
                                    (774, [774, 774]), (2838, [2838, 2838]),
                                    (255, [255, 1]), (300, [300, 0])])
def test_k3_cuda_matches_plain(cuda_device, T, lens):
    q, k, v, mask = _k3_inputs(cuda_device, T, lens)
    got = k3.dit_attention(q, k, v, mask)
    want = k3.dit_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert (got - want).abs().max() <= 2e-5
    if 0 in lens:
        row = lens.index(0)
        mean = v[row].mean(dim=1, keepdim=True).expand(-1, T, -1)
        torch.testing.assert_close(got[row], mean, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_k3_cuda_repeats_its_bits(cuda_device):
    q, k, v, mask = _k3_inputs(cuda_device, 774, [774, 500])
    assert torch.equal(k3.dit_attention(q, k, v, mask), k3.dit_attention(q, k, v, mask))


@pytest.mark.cuda
def test_k3_cuda_reads_strided_views(cuda_device):
    """The DiT's q, k (transposed (B, T, H, Dh)) and v (a slice of the fused
    qkv projection) give the bits of their contiguous copies, with no copy
    made, and the output transposes back to (B, T, H * Dh) as a view."""
    B, T, H = 2, 300, 8
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((B, T, 3 * H * 64), generator=g, device=cuda_device)
    rot = torch.randn((2, B, T, H, 64), generator=g, device=cuda_device)
    q, k = (x.transpose(1, 2) for x in rot)
    v = qkv[..., 2 * H * 64:].reshape(B, T, H, 64).transpose(1, 2)
    assert all(k3.kernel_operand(x) is x for x in (q, k, v))
    mask = torch.arange(T, device=cuda_device)[None] < torch.tensor([[T], [200]],
                                                                     device=cuda_device)
    got = k3.dit_attention(q, k, v, mask)
    want = k3.dit_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()


# K3's bfloat16 instantiation at chip_smoke.py's shapes: the main path's
# CFG-stacked solve (T=898, 774 valid frames), the longest segment (T=2946,
# 2838 valid), T=37 below one tile, a row with one valid key, a row with
# none, a batched solve's 16 rows (chip_smoke.py's `batch_dit_valid`, in
# the cond and the null half), and a row whose first 128-key tile and a
# middle one hold no valid key beside a row with none, at 2 rows and at 16
# (the kernel's blocks of 2 and of 3 consumer warpgroups). The plain version
# rounds the scores to bfloat16 before its float32 softmax (the JAX XLA
# path); the kernel keeps them in float32 and rounds only the
# probabilities and the output. So each is held to the float32 attention
# of the same bfloat16 inputs: the kernel at most as far from it as the
# plain version, and the two within 3e-2 of max|out| of each other (the
# plain version's score rounding alone moves it ~1.4e-2).
K3_BF16_CASES = [(898, [774, 774]), (2946, [2838, 2838]), (37, [37, 20]), (255, [255, 1]),
                 (300, [300, 0]), (898, [774, 710, 646, 583, 519, 455, 392, 328] * 2),
                 (898, ["masked-head", 0]), (898, ["masked-head", 0] * 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", K3_BF16_CASES)
def test_k3_bf16_cuda_matches_plain(cuda_device, T, lens):
    q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                     for x in _k3_inputs(cuda_device, T, lens))
    counted = k3.bf16_counter.launches, k3.counter.launches
    got = k3.dit_attention(q, k, v, mask)
    assert got.dtype == torch.bfloat16
    assert (k3.bf16_counter.launches, k3.counter.launches) == (counted[0] + 1, counted[1])
    want = k3.dit_attention_plain(q, k, v, mask).float()
    exact = k3.dit_attention_plain(q.float(), k.float(), v.float(), mask)
    top = exact.abs().max()
    err, plain_err = (got.float() - exact).abs().max(), (want - exact).abs().max()
    assert err <= plain_err, (err, plain_err)
    assert (got.float() - want).abs().max() <= 3e-2 * top


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", K3_BF16_CASES)
def test_k3_bf16_cuda_masking_is_exact(cuda_device, T, lens):
    """A masked key adds exactly nothing, whether its tile is skipped or
    masked: with the k and v of every masked key replaced by other finite
    draws (x100), each row with a valid key keeps its bits."""
    q, k, v, mask = (x.bfloat16() if x.is_floating_point() else x
                     for x in _k3_inputs(cuda_device, T, lens))
    got = k3.dit_attention(q, k, v, mask)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    masked = ~mask[:, None, :, None]
    k2, v2 = (torch.where(masked, 100 * torch.randn(x.shape, generator=g, device=cuda_device)
                          .bfloat16(), x) for x in (k, v))
    again = k3.dit_attention(q, k2, v2, mask)
    for r in range(len(lens)):
        if mask[r].any():
            assert torch.equal(again[r], got[r]), r


@pytest.mark.cuda
@pytest.mark.parametrize("B,cap,vl,hs,he", DECODE_CASES)
def test_k4_cuda_matches_plain(cuda_device, B, cap, vl, hs, he):
    args = _k4_args(cuda_device, B, cap, _decode_ints(cuda_device, vl, hs, he))
    got = k1.ragged_decode_attention_q8(*args)
    want = k1.ragged_decode_attention_q8_plain(*args)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert (got - want).abs().max() <= 2e-5


def _q8(g, dev, d, f):
    from indextts_tpu_torch.models.gpt2 import quantize_weight

    w_q, s = quantize_weight(torch.randn((d, f), generator=g, device=dev) / d ** 0.5)
    return w_q, s, torch.randn((f,), generator=g, device=dev) * 0.1


# (rows, D, F): the full-width shapes (c_attn, attn c_proj, the logits head,
# whose last 256-column tile is half used) at 1, 3 and 16 rows; D=256 at
# F=384; D=2048 (c_attn 2048 x 6144); 17 and 40 rows in chunks of 16; D=32768,
# whose blocks take their rows in three passes (gemv.gemv_plan)
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,f", [(1, 1280, 3840), (3, 1280, 8320), (2, 256, 384),
                                   (17, 1280, 3840), (40, 1280, 3840), (1, 1280, 1280),
                                   (1, 1280, 8320), (16, 1280, 3840), (16, 1280, 1280),
                                   (16, 1280, 8320), (1, 2048, 6144), (16, 2048, 6144),
                                   (3, 32768, 1280)])
def test_k5_cuda_matches_plain(cuda_device, b, d, f):
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((b, d), generator=g, device=cuda_device))
    w = _q8(g, cuda_device, d, f)
    got = gemv.gemv_w8(xq, a, *w)
    want = gemv.gemv_w8_plain(xq, a, *w)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.cuda
def test_k5_cuda_replays_its_bits(cuda_device):
    """Two more calls and two replays of a CUDA graph of one call give the
    first call's bits (c_attn at full width)."""
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((1, 1280), generator=g, device=cuda_device))
    w = _q8(g, cuda_device, 1280, 3840)
    _replays_equal(lambda: gemv.gemv_w8(xq, a, *w), gemv.gemv_w8(xq, a, *w))


def _replays_equal(fn, got):
    """Two more calls, then two replays of a CUDA graph of one call, give
    `got` to the bit (the fused MLPs' arrival counters re-arm each call).
    The graph is captured on the stream it was warmed up on, which made its
    counters."""
    assert torch.equal(fn(), got) and torch.equal(fn(), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


# (rows, D, replayed): D=128 is one group (FH=512), 16 rows the second
# instantiation; D=1536 and D=2048 give each block 48 and 32 hidden columns
# (64 at full width), the kernel's other shuffle paths, and 16 rows at
# D=2048 the largest shared memory of these cases; 17 and 40 rows go in
# chunks of 16, and 16 rows at D=2560 in chunks of 12 (gemv.mlp_rows)
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,replay", [(1, 1280, False), (3, 512, False), (1, 128, False),
                                        (16, 1280, False), (1, 1280, True), (1, 1536, False),
                                        (1, 2048, False), (16, 2048, False), (17, 1280, False),
                                        (40, 1280, False), (16, 2560, False)])
def test_k6_cuda_matches_plain(cuda_device, b, d, replay):
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((b, d), generator=g, device=cuda_device))
    ws = _q8(g, cuda_device, d, 4 * d) + _q8(g, cuda_device, 4 * d, d)
    got = gemv.mlp_w8(xq, a, *ws)
    want = gemv.mlp_w8_plain(xq, a, *ws)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    if replay:
        _replays_equal(lambda: gemv.mlp_w8(xq, a, *ws), got)


def _q4(g, dev, d, f, cols=False):
    from indextts_tpu_torch.models.gpt2 import quantize_weight_w4

    w_p, s = quantize_weight_w4(torch.randn((d, f), generator=g, device=dev) / d ** 0.5, cols)
    return w_p, s, torch.randn((f,), generator=g, device=dev) * 0.1


# (rows, D, F) as for K5: c_attn and attn c_proj at 1, 3 and 16 rows, F=384,
# 17 and 40 rows in chunks, D=2048, and D=65536 (32768 packed rows, three passes)
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,f", [(1, 1280, 3840), (3, 1280, 3840), (1, 1280, 1280),
                                   (3, 1280, 1280), (1, 1280, 384), (17, 1280, 3840),
                                   (40, 1280, 3840), (16, 1280, 3840), (16, 1280, 1280),
                                   (1, 2048, 6144), (16, 2048, 6144), (3, 65536, 1280)])
def test_k7_cuda_matches_plain(cuda_device, b, d, f):
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((b, d), generator=g, device=cuda_device))
    w = _q4(g, cuda_device, d, f)
    got = gemv.gemv_w4(xq, a, *w)
    assert torch.equal(got, gemv.gemv_w4_plain(xq, a, *w))


@pytest.mark.cuda
def test_k7_cuda_replays_its_bits(cuda_device):
    """As for K5: c_attn at full width, called again and replayed."""
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((1, 1280), generator=g, device=cuda_device))
    w = _q4(g, cuda_device, 1280, 3840)
    _replays_equal(lambda: gemv.gemv_w4(xq, a, *w), gemv.gemv_w4(xq, a, *w))


# (rows, D, replayed): D=256 is one group (FH=1024); D=1536 and D=2048 as
# for K6; 17 and 40 rows in chunks of 16, 16 rows at D=3328 in chunks of 15
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,replay", [(1, 1280, False), (3, 1280, False), (1, 512, False),
                                        (3, 512, False), (1, 256, False), (16, 1280, False),
                                        (1, 1280, True), (1, 1536, False), (1, 2048, False),
                                        (16, 2048, False), (17, 1280, False), (40, 1280, False),
                                        (16, 3328, False)])
def test_k8_cuda_matches_plain(cuda_device, b, d, replay):
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((b, d), generator=g, device=cuda_device))
    ws = _q4(g, cuda_device, d, 4 * d) + _q4(g, cuda_device, 4 * d, d, cols=True)
    got = gemv.mlp_w4(xq, a, *ws)
    want = gemv.mlp_w4_plain(xq, a, *ws)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    if replay:
        _replays_equal(lambda: gemv.mlp_w4(xq, a, *ws), got)


@pytest.mark.cuda
def test_mlp_first_call_under_capture_raises(cuda_device):
    """A stream's first fused-MLP call makes and zeroes its arrival
    counters. Under graph capture the zeroing would only be recorded, so
    that call raises; after one call on the stream, capture works."""
    from indextts_tpu_torch.models.gpt2 import quant_row

    g = torch.Generator(device=cuda_device).manual_seed(0)
    xq, a = quant_row(torch.randn((1, 512), generator=g, device=cuda_device))
    ws = _q8(g, cuda_device, 512, 2048) + _q8(g, cuda_device, 2048, 512)
    fresh = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="graph capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            gemv.mlp_w8(xq, a, *ws)
    got = gemv.mlp_w8(xq, a, *ws)
    want = gemv.mlp_w8_plain(xq, a, *ws)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    _replays_equal(lambda: gemv.mlp_w8(xq, a, *ws), got)


# ---------------------------------------------------------------------------
# the decode loop: a captured step against the eager one
# ---------------------------------------------------------------------------

# route: (gpt_quantize, gpt_wbits); quantized routes take the int8 head, the
# int8 KV cache and the decode kernels (K4-K8; at D=256 every gate opens)
GRAPH_ROUTES = {"float": (False, 8), "w8": (True, 8), "w4": (True, 4)}


def _graph_decoder(dev, route):
    """A 2-layer GPT of width 256 (4 heads of 64) on `route` with seeded
    random weights, and its sampling decoder, on the card."""
    from indextts_tpu_torch import config as C
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.weights import quantize_gpt_state_dict

    cfg = C.GPTConfig(
        model_dim=256, layers=2, heads=4, max_mel_tokens=64, max_text_tokens=32,
        number_text_tokens=50, number_mel_codes=36, start_mel_token=34, stop_mel_token=35,
        condition_module=C.ConditionModuleConfig(
            output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
        emo_condition_module=C.ConditionModuleConfig(
            output_size=32, linear_units=32, attention_heads=2, num_blocks=1))
    quantize, wbits = GRAPH_ROUTES[route]
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        with torch.device(dev):
            model = UnifiedVoice(cfg)
    if quantize:
        sd = quantize_gpt_state_dict(model.state_dict(), head=True, bits=wbits)
        with torch.device("meta"):
            model = UnifiedVoice(cfg, quantize=True, head_quant=True, wbits=wbits, gemv=True)
        model.load_state_dict(sd, strict=True, assign=True)
    model = model.eval().requires_grad_(False)
    dec = GPTDecoder(model, cfg, SamplingConfig(do_sample=True, top_k=20), kv_int8=quantize)
    g = torch.Generator(device=dev).manual_seed(1)
    conds = torch.randn((1, 34, 256), generator=g, device=dev)
    text = torch.randint(2, 50, (1, 9), generator=g, device=dev).cpu().numpy()
    arrays = dec.build_text_prompt_arrays(text, np.array([9]), 12)
    return dec, (conds, *(torch.as_tensor(a, device=dev) for a in arrays))


def _counts():
    return {name: c.launches for name, c in (
        ("K1", k1.counter), ("K4", k1.q8_counter), ("K5", gemv.gemv_counter),
        ("K6", gemv.mlp_counter), ("K7", gemv.gemv4_counter), ("K8", gemv.mlp4_counter))}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_graph_decode_matches_eager(cuda_device, route):
    """One seed, one code row: the captured loop (its first request
    captures, the second replays from the start) and the eager loop on the
    same stream and state give the same codes and lengths. 40 codes cross
    two finish checks."""
    dec, args = _graph_decoder(cuda_device, route)
    runs = [dec.generate(*args, 3, max_new=40, eager=eager) for eager in (True, False, False)]
    for r in runs[1:]:
        assert torch.equal(r.codes, runs[0].codes)
        assert torch.equal(r.lengths, runs[0].lengths)
    assert [len(st.graphs) for st in dec._states.values()] == [1]
    assert len(set(runs[0].codes[0].tolist())) > 3  # not a degenerate row


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_decode_step_makes_no_host_sync(cuda_device, route):
    """An eager step and a replay of the captured one, under
    set_sync_debug_mode("error"), which raises on any host sync."""
    dec, args = _graph_decoder(cuda_device, route)
    dec.generate(*args, 3, max_new=20)
    (st,) = dec._states.values()
    graph, _ = st.graphs[True]
    step = int(st.step)
    with torch.inference_mode(), torch.cuda.stream(dec._stream):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec._advance(st, True)
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(st.step) == step + 2


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_graph_decode_counts_the_eager_launches(cuda_device, route):
    """After a request the kernels' launch counters read what the eager
    loop's launches give: a replay adds its captured step's rise. 2 layers
    x the steps of K1 or K4; W8 2 x 2 + 1 (the head) K5 a step, W4 one head
    K5, and one more K5 for the prefill's head; the first request (capture) and a later one (replays only). Steps:
    one fewer than the codes up to the finish check after the stop, at
    most 39."""
    dec, args = _graph_decoder(cuda_device, route)
    counts = []
    for eager in (True, False, False):
        for c in (k1.counter, k1.q8_counter, gemv.gemv_counter, gemv.mlp_counter,
                  gemv.gemv4_counter, gemv.mlp4_counter):
            c.launches = 0
        res = dec.generate(*args, 3, max_new=40, eager=eager)
        counts.append(_counts())
    assert counts[1] == counts[0] and counts[2] == counts[0]
    quantize, wbits = GRAPH_ROUTES[route]
    steps = min(-(-int(res.lengths[0]) // 16) * 16, 40) - 1
    want = {"K1": 0 if quantize else 2 * steps, "K4": 2 * steps if quantize else 0,
            "K5": (5 if wbits == 8 else 1) * steps + 1 if quantize else 0,
            "K6": 2 * steps if quantize and wbits == 8 else 0,
            "K7": 4 * steps if quantize and wbits == 4 else 0,
            "K8": 2 * steps if quantize and wbits == 4 else 0}
    assert counts[0] == want


# ---------------------------------------------------------------------------
# beam search: the captured beam step against the eager one
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("route", ["float", "w8"])
def test_graph_beam_matches_eager(cuda_device, route, do_sample):
    """Beam search over 3 beams, deterministic and beam-multinomial: the
    captured step (the first request captures, the second replays from the
    start) and the eager one on the same stream and state give the same
    codes and lengths from one seed; the W8 route's beams keep an int8
    cache. 40 steps cross two finish checks."""
    dec, args = _graph_decoder(cuda_device, route)
    kw = dict(max_new=40, num_beams=3, do_sample=do_sample, temperature=0.8, top_p=0.8)
    runs = [dec.generate_beam(*args, 3, eager=eager, **kw) for eager in (True, False, False)]
    for r in runs[1:]:
        assert torch.equal(r.codes, runs[0].codes)
        assert torch.equal(r.lengths, runs[0].lengths)
    (st,) = dec._states.values()
    assert list(st.graphs) == [do_sample]
    assert (st.caches[0].dtype == torch.int8) == (route == "w8")
    assert 1 <= int(runs[0].lengths[0]) <= 40


@pytest.mark.cuda
@pytest.mark.parametrize("do_sample", [False, True])
def test_beam_step_makes_no_host_sync(cuda_device, do_sample):
    """An eager beam step and a replay of the captured one, under
    set_sync_debug_mode("error"), which raises on any host sync."""
    dec, args = _graph_decoder(cuda_device, "w8")
    dec.generate_beam(*args, 3, max_new=20, num_beams=3, do_sample=do_sample)
    (st,) = dec._states.values()
    graph, _ = st.graphs[do_sample]
    with torch.inference_mode(), torch.cuda.stream(dec._stream):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec._beam_step(st, do_sample)
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_beam_graph_captured_once_per_shape(cuda_device):
    """A beam state's graph is captured once per (num_beams, cap): a second
    request of the same shape replays it; another cap or beam count gets
    its own state, and a sampling request of as many rows would too (keys
    ("beam", nb, cap) against (B, cap))."""
    dec, args = _graph_decoder(cuda_device, "float")

    def graphs():
        return {key: len(st.graphs) for key, st in dec._states.items()}

    dec.generate_beam(*args, 3, max_new=40, num_beams=3)
    dec.generate_beam(*args, 4, max_new=40, num_beams=3)
    assert graphs() == {("beam", 3, 256): 1}
    dec.generate_beam(*args, 3, max_new=300, num_beams=3)
    dec.generate_beam(*args, 3, max_new=40, num_beams=2)
    dec.generate(*args, 3, max_new=40)
    assert graphs() == {("beam", 3, 256): 1, ("beam", 3, 512): 1, ("beam", 2, 256): 1,
                        (1, 256): 1}


# ---------------------------------------------------------------------------
# continuous batching: the captured batched step against the eager one
# ---------------------------------------------------------------------------


def _slot_batcher(dev, route, n_slots=4):
    """The 2-layer width-256 GPT of `route` (`_graph_decoder`), sampling,
    and a batcher of `n_slots` slots whose rows sit at unequal positions
    (admitted 5, 3 and 2 steps apart, in turn) and unequal holes (texts of
    3-12 ids in a bucket of 12)."""
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    dec, _ = _graph_decoder(dev, route)
    bat = ContinuousBatcher(dec, n_slots=n_slots, text_bucket=12, max_new=60, chunk_steps=8,
                            seed=3)
    g = torch.Generator(device=dev).manual_seed(2)
    admits = [((3, 12, 7, 9)[i % 4], (5, 3, 2, 0)[i % 4]) for i in range(n_slots)]
    with torch.inference_mode(), dec.on_stream():
        for n_text, steps in admits:
            conds = torch.randn((1, 34, 256), generator=g, device=dev)
            bat.submit(conds, torch.randint(2, 50, (n_text,), generator=g,
                                            device=dev).cpu().numpy())
            bat._admit()
            dec.step_chunk(bat.state, steps, True, eager=True)
    torch.cuda.synchronize()
    return dec, bat


@torch.inference_mode()
def _snapshot(st):
    return [t.clone() for t in st.tensors()]


@torch.inference_mode()
def _restore(st, snap, seed):
    for t, s in zip(st.tensors(), snap):
        t.copy_(s)
    st.generator.manual_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_batched_step_graph_matches_eager(cuda_device, route):
    """From one state and seed, 8 batched sampling steps eagerly, then
    captured (the first step eager, the capture taken while another thread
    runs K3 on its own stream, 7 replays), then replayed 8 times: every
    buffer of the state (caches, logits, codes, counts, flags) the same
    bits all three ways."""
    dec, bat = _slot_batcher(cuda_device, route)
    st = bat.state
    snap = _snapshot(st)
    q, k, v, mask = _k3_inputs(cuda_device, 300, [300, 150])
    stop = threading.Event()

    def tail():
        with torch.cuda.stream(torch.cuda.Stream()):
            while not stop.is_set():
                k3.dit_attention(q, k, v, mask)
                torch.cuda.current_stream().synchronize()

    runs = []
    for eager in (True, False, False):
        _restore(st, snap, 11)
        th = threading.Thread(target=tail)
        th.start()
        try:
            with torch.inference_mode(), dec.on_stream():
                dec.step_chunk(st, 8, True, eager=eager)
            torch.cuda.synchronize()
        finally:
            stop.set()
            th.join(timeout=60)
            stop.clear()
        runs.append(_snapshot(st))
    assert list(st.graphs) == [True]
    for got in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], snap))
    assert bool(st.active.all())


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_batched_step_makes_no_host_sync(cuda_device, route):
    """An eager batched step and a replay of the captured one, under
    set_sync_debug_mode("error"), which raises on any host sync."""
    dec, bat = _slot_batcher(cuda_device, route)
    st = bat.state
    pos = st.pos.clone()
    with torch.inference_mode(), dec.on_stream():
        dec.step_chunk(st, 2, True)
        graph, _ = st.graphs[True]
        torch.cuda.set_sync_debug_mode("error")
        try:
            dec.slot_step(st, True)
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int((st.pos - pos).max()) == 4


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_batched_step_counts_each_replay_once(cuda_device, route):
    """A chunk of 8 batched steps raises the kernels' counters by the
    eager chunk's launches, whether it captures (one eager step, the
    capture, 7 replays) or only replays: per step, 2 layers of K1 or K4 (one
    launch for the 4 rows); W8 2 x 2 + 1 (the head) K5 and 2 K6; W4 one
    head K5, 4 K7 and 2 K8."""
    dec, bat = _slot_batcher(cuda_device, route)
    st = bat.state
    snap = _snapshot(st)
    counts = []
    for eager in (True, False, False):
        _restore(st, snap, 11)
        for c in (k1.counter, k1.q8_counter, gemv.gemv_counter, gemv.mlp_counter,
                  gemv.gemv4_counter, gemv.mlp4_counter):
            c.launches = 0
        with torch.inference_mode(), dec.on_stream():
            dec.step_chunk(st, 8, True, eager=eager)
        counts.append(_counts())
    quantize, wbits = GRAPH_ROUTES[route]
    want = {"K1": 0 if quantize else 16, "K4": 16 if quantize else 0,
            "K5": (5 if wbits == 8 else 1) * 8 if quantize else 0,
            "K6": 16 if quantize and wbits == 8 else 0,
            "K7": 32 if quantize and wbits == 4 else 0,
            "K8": 16 if quantize and wbits == 4 else 0}
    assert counts == [want] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["w8", "w4"])
def test_batched_step_launches_k5_to_k8_past_16_slots(cuda_device, route):
    """20 slots, more rows than one K5-K8 launch takes: a chunk of 8
    batched steps (one eager step, the capture, 7 replays) launches the
    kernels in chunks of rows, none of the calls stepping aside to the
    plain contraction. Per step and call: ceil(20 / 16) K5 or K7 launches
    and ceil(20 / mlp_rows) K6 or K8 launches; K4 one launch a layer. The
    captured chunk leaves the state's bits as the eager chunk does."""
    dec, bat = _slot_batcher(cuda_device, route, n_slots=20)
    st = bat.state
    snap = _snapshot(st)
    quantize, wbits = GRAPH_ROUTES[route]
    w4 = wbits == 4
    hb = gemv.mlp_group_w4(256, 1024) if w4 else gemv.mlp_group(256, 1024)
    per_gemv = -(-20 // gemv.MAX_ROWS)
    per_mlp = -(-20 // gemv.mlp_rows(256, hb, w4))
    want = {"K1": 0, "K4": 2 * 8,
            "K5": (1 if w4 else 5) * per_gemv * 8, "K6": 0 if w4 else 2 * per_mlp * 8,
            "K7": 4 * per_gemv * 8 if w4 else 0, "K8": 2 * per_mlp * 8 if w4 else 0}
    assert per_gemv == 2 and per_mlp >= 2
    runs = []
    for eager in (True, False):
        _restore(st, snap, 11)
        for c in (k1.counter, k1.q8_counter, gemv.gemv_counter, gemv.mlp_counter,
                  gemv.gemv4_counter, gemv.mlp4_counter):
            c.launches = 0
        with torch.inference_mode(), dec.on_stream():
            dec.step_chunk(st, 8, True, eager=eager)
        torch.cuda.synchronize()
        assert _counts() == want
        runs.append(_snapshot(st))
    assert all(torch.equal(a, b) for a, b in zip(runs[1], runs[0]))
    assert bool(st.active.all())


# ---------------------------------------------------------------------------
# the s2mel stage's CFM solve: a captured graph replayed against the eager solve
# ---------------------------------------------------------------------------


def _s2mel_runner(dev, depth=3, n_steps=4):
    """An S2Mel whose DiT has `depth` layers of width 128 (2 heads of 64,
    K3's head width) and a 2-layer WaveNet, seeded random weights, and its
    runner of `n_steps` Euler steps, on the card."""
    from indextts_tpu_torch import config as C
    from indextts_tpu_torch.models.s2mel import S2Mel
    from indextts_tpu_torch.runtime.s2mel_infer import S2MelRunner

    cfg = C.S2MelConfig(
        length_regulator=C.LengthRegulatorConfig(channels=64, in_channels=64),
        dit=C.DiTConfig(hidden_dim=128, num_heads=2, depth=depth, content_dim=64),
        wavenet=C.WaveNetConfig(hidden_dim=64, num_layers=2, kernel_size=5),
        gpt_dims=(64, 64))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        with torch.device(dev):
            model = S2Mel(cfg).eval().requires_grad_(False)
    return S2MelRunner(model, n_steps=n_steps, cfg_rate=0.7)


def _solve_inputs(dev, T, ref, valid, seed):
    """A solve's inputs at width T: the prompt's `ref` frames, `valid`
    frames in all, the rest padding."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn((1, T, 64), generator=g, device=dev)
    mu[:, valid:] = 0
    prompt_x = torch.zeros((1, 80, T), device=dev)
    prompt_x[:, :, :ref] = torch.randn((1, 80, ref), generator=g, device=dev)
    style = torch.randn((1, 192), generator=g, device=dev)
    noise = torch.randn((1, 80, T), generator=g, device=dev)
    return mu, torch.tensor([valid], device=dev), prompt_x, ref, style, noise


@pytest.mark.cuda
def test_s2mel_graph_matches_eager(cuda_device):
    """The captured solve (the first call captures and replays, later ones
    replay) gives the eager solve's bits, for two requests of one width with
    other prompt lengths and valid lengths: one graph serves both."""
    runner = _s2mel_runner(cuda_device)
    reqs = [_solve_inputs(cuda_device, 300, 90, 271, 1),
            _solve_inputs(cuda_device, 300, 40, 300, 2)]
    want = [runner.solve(*a, eager=True) for a in reqs]
    for _ in range(2):
        for a, w in zip(reqs, want):
            got = runner.solve(*a)
            assert torch.equal(got, w)
    assert runner.shapes() == [((1, 300), True)]
    assert cuda_lib.pool_bytes(runner.pool) > 0
    assert not torch.equal(want[0], want[1])


@pytest.mark.cuda
def test_s2mel_replay_makes_no_host_sync(cuda_device):
    """A solve whose graph is captured, under set_sync_debug_mode("error"),
    which raises on any host sync: copy in, replay, copy out."""
    runner = _s2mel_runner(cuda_device)
    a = _solve_inputs(cuda_device, 200, 50, 180, 3)
    want = runner.solve(*a)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = runner.solve(*a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_s2mel_graph_threads_get_their_own_mels(cuda_device):
    """Two threads solving at one width at once, 4 times each with their
    own requests: each gets its request's eager mel, to the bit."""
    import sys

    runner = _s2mel_runner(cuda_device)
    reqs = [_solve_inputs(cuda_device, 256, 60 + 30 * i, 200 + 20 * i, 10 + i) for i in range(2)]
    want = [runner.solve(*a, eager=True) for a in reqs]
    got = [[None] * 4 for _ in reqs]

    def run(i):
        for r in range(4):
            got[i][r] = runner.solve(*reqs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i])
    assert runner.shapes() == [((1, 256), True)]


@pytest.mark.cuda
def test_s2mel_graph_lru_recaptures(cuda_device, monkeypatch):
    """With room for 2 solve shapes, a third evicts the least recently
    used; that width's next solve captures again and gives the eager
    bits."""
    from indextts_tpu_torch.runtime import s2mel_infer

    monkeypatch.setattr(s2mel_infer, "MAX_SOLVES", 2)
    runner = _s2mel_runner(cuda_device)
    reqs = {T: _solve_inputs(cuda_device, T, 50, T - 20, T) for T in (128, 256, 384)}
    want = {T: runner.solve(*a, eager=True) for T, a in reqs.items()}
    for T in (128, 256, 384, 128):
        assert torch.equal(runner.solve(*reqs[T]), want[T])
    assert runner.shapes() == [((1, 384), True), ((1, 128), True)]


@pytest.mark.cuda
def test_s2mel_graph_counts_k3(cuda_device):
    """K3's counter through replays: 20 steps x 13 DiT layers, 260 a
    solve, as many as the eager solve launches; a shape's first call adds
    its one-step warm-up (13) before the capture, which launches nothing."""
    runner = _s2mel_runner(cuda_device, depth=13, n_steps=20)
    a = _solve_inputs(cuda_device, 200, 50, 180, 4)
    counts = []
    for eager in (True, False, False):
        k3.counter.launches = 0
        runner.solve(*a, eager=eager)
        counts.append(k3.counter.launches)
    assert counts == [260, 13 + 260, 260]


@pytest.mark.cuda
def test_s2mel_and_decode_capture_side_by_side(cuda_device):
    """A thread capturing s2mel solves at new widths beside one capturing
    decode steps at new batch sizes (a tail beside the sequential route's
    next request): captures take turns (`cuda_lib.capture`; the device-wide
    synchronize that begins one would end the other's), and every result
    is the eager one's bits."""
    runner = _s2mel_runner(cuda_device)
    dec, args = _graph_decoder(cuda_device, "float")
    pair = tuple(torch.cat([a, a]) for a in args)
    solves = [_solve_inputs(cuda_device, T, 40, T - 10, T) for T in (128, 256, 384, 512)]
    want_mel = [runner.solve(*a, eager=True) for a in solves]
    jobs = [(args, 20), (pair, 20), (args, 40), (pair, 40)]  # decode states (1|2, 256)
    want_codes = [dec.generate(*a, 3, max_new=m, eager=True).codes for a, m in jobs]
    got_mel, got_codes, errors = [], [], []

    def mels():
        try:
            got_mel.extend(runner.solve(*a) for a in solves)
        except Exception as e:  # reported below
            errors.append(e)

    def codes():
        try:
            got_codes.extend(dec.generate(*a, 3, max_new=m).codes for a, m in jobs)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=mels), threading.Thread(target=codes)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and errors == []
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got_mel, want_mel)) and len(got_mel) == 4
    assert all(torch.equal(g, w) for g, w in zip(got_codes, want_codes)) and len(got_codes) == 4
    assert [key for key, _ in runner.shapes()] == [(1, T) for T in (128, 256, 384, 512)]
    assert [len(st.graphs) for st in dec._states.values()] == [1, 1]


# ---------------------------------------------------------------------------
# the cascade tail's other stages: the latent pass and the vocoder, each a
# captured graph per bucket (runtime/graphs.py)
# ---------------------------------------------------------------------------


def _latent_request(dev, n, code_len, seed, Lt=32, Lm=64):
    """The latent runner's inputs for `_graph_decoder`'s GPT (width 256):
    n valid text ids of Lt, code_len valid codes of Lm."""
    g = torch.Generator(device=dev).manual_seed(seed)
    spk = torch.randn((1, 32, 256), generator=g, device=dev)
    emovec = torch.randn((1, 256), generator=g, device=dev)
    text = torch.randint(2, 50, (1, Lt), generator=g, device=dev)
    codes = torch.randint(0, 34, (1, Lm), generator=g, device=dev)
    return (spk, text, torch.tensor([n], device=dev), codes,
            torch.tensor([code_len], device=dev), emovec)


def _vocoder(dev, pcm16=False):
    """The default config's BigVGAN (37 K2 launches a call), seeded random
    weights, and its runner, on the card."""
    from indextts_tpu_torch import config as C
    from indextts_tpu_torch.models.bigvgan import BigVGAN
    from indextts_tpu_torch.runtime.graphs import VocoderRunner

    torch.backends.cudnn.allow_tf32 = False
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        with torch.device(dev):
            model = BigVGAN(C.BigVGANConfig()).eval().requires_grad_(False)
    return VocoderRunner(model, pcm16)


def _mel(dev, T, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((1, 80, T), generator=g, device=dev) - 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_latent_graph_matches_eager(cuda_device, route):
    """The captured latent pass gives the eager pass's bits, for two
    requests of one (text width, code width) with other valid lengths, on
    the float, W8 and W4 GPTs: one graph serves both."""
    from indextts_tpu_torch.runtime.graphs import LatentRunner

    dec, _ = _graph_decoder(cuda_device, route)
    runner = LatentRunner(dec.model)
    reqs = [_latent_request(cuda_device, 9, 23, 1), _latent_request(cuda_device, 32, 64, 2)]
    want = [runner.latent(*a, eager=True) for a in reqs]
    for _ in range(2):
        for a, w in zip(reqs, want):
            assert torch.equal(runner.latent(*a), w)
    assert runner.keys() == {(1, 32, 64): True}
    assert cuda_lib.pool_bytes(runner.pool) > 0
    assert want[0].shape == (1, 64, 256) and not torch.equal(want[0], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pcm16", [False, True])
def test_vocoder_graph_matches_eager_and_counts_k2(cuda_device, pcm16):
    """The captured vocoder gives the eager call's bits (float32, or int16
    under the PCM16 clip), and K2's counter through replays: 37 a call, as
    the eager call launches; a width's first call adds its eager warm-up
    (37) before the capture, which launches nothing."""
    runner = _vocoder(cuda_device, pcm16)
    mels = [_mel(cuda_device, 32, 1), _mel(cuda_device, 32, 2)]
    counts, want = [], []
    for m in mels:
        k2.counter.launches = 0
        want.append(runner.vocode(m, eager=True))
        counts.append(k2.counter.launches)
    for _ in range(2):
        for m, w in zip(mels, want):
            k2.counter.launches = 0
            assert torch.equal(runner.vocode(m), w)
            counts.append(k2.counter.launches)
    assert counts == [37, 37, 74, 37, 37, 37]
    assert want[0].shape == (1, 32 * 256)
    assert want[0].dtype == (torch.int16 if pcm16 else torch.float32)
    assert runner.keys() == {(1, 32): True}


@pytest.mark.cuda
def test_tail_graphs_threads_get_their_own_bits(cuda_device):
    """Two threads, each running its own request's latent pass and vocoder
    call 4 times at once on shared runners: each gets its request's eager
    bits."""
    import sys

    from indextts_tpu_torch.runtime.graphs import LatentRunner

    dec, _ = _graph_decoder(cuda_device, "float")
    latent, vocoder = LatentRunner(dec.model), _vocoder(cuda_device)
    reqs = [(_latent_request(cuda_device, 9 + 10 * i, 20 + 30 * i, 20 + i),
             _mel(cuda_device, 64, 30 + i)) for i in range(2)]
    want = [(latent.latent(*a, eager=True), vocoder.vocode(m, eager=True)) for a, m in reqs]
    got = [[] for _ in reqs]

    def run(i):
        for _ in range(4):
            a, m = reqs[i]
            got[i].append((latent.latent(*a), vocoder.vocode(m)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    for i in range(2):
        assert len(got[i]) == 4
        assert all(torch.equal(lat, want[i][0]) and torch.equal(wav, want[i][1])
                   for lat, wav in got[i])


@pytest.mark.cuda
def test_precompile_leaves_no_capture_to_a_request(cuda_device):
    """A small engine on the card: precompile over an envelope of 24 codes
    and one text bucket captures every program a request inside it runs; the
    request then captures nothing new, and its audio is finite."""
    import chip_smoke

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    cfg = chip_smoke.small_config()
    eng = IndexTTS2Engine(cfg, random_params(cfg, seed=0, device=cuda_device),
                          device=cuda_device)
    t = np.arange(16000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
           ).astype(np.float32)
    spk = eng.prepare_speaker(wav, 16000)
    jobs = eng.precompile(spk, text_buckets=[16], max_code_len=cfg.runtime.max_mel_tokens)
    # decode 1 + latent 1 x 1 + s2mel 1 + vocoder 1
    assert jobs == 4
    before = chip_smoke.graph_counts(eng)  # (decode, latent, s2mel, vocoder)
    assert before == (1, 1, 1, 1)
    out = eng.infer((wav, 16000), [np.arange(2, 14)], seed=0)
    assert chip_smoke.graph_counts(eng) == before
    assert out["audio"].size and np.isfinite(out["audio"]).all()


def _stack(reqs):
    """One-row runner requests as the rows of one batched request (a Python
    number, the same in each, kept)."""
    return tuple(torch.cat(parts) if isinstance(parts[0], torch.Tensor) else parts[0]
                 for parts in zip(*reqs))


@pytest.mark.cuda
def test_batched_keys_sit_beside_one_row_keys(cuda_device, monkeypatch):
    """Each tail runner keys on B: a batched call (3 rows, unequal valid
    lengths) captures its own key beside the one-row key of the same
    widths, its replays give the eager call's bits, and batched keys evict
    only batched keys (MAX_BATCHED, here 1), never a one-row key."""
    from indextts_tpu_torch.runtime import graphs
    from indextts_tpu_torch.runtime.graphs import LatentRunner

    monkeypatch.setattr(graphs, "MAX_BATCHED", 1)
    dec, _ = _graph_decoder(cuda_device, "float")
    lat = [_latent_request(cuda_device, 9 + 10 * i, 20 + 20 * i, 40 + i) for i in range(3)]
    solves = [_solve_inputs(cuda_device, 256, 50, 256 - 40 * i, 50 + i) for i in range(3)]
    mels = [(_mel(cuda_device, 32, 60 + i),) for i in range(3)]
    stages = [  # (runner, call, one-row requests, the B=3 key)
        (LatentRunner(dec.model), "latent", lat, (3, 32, 64)),
        (_s2mel_runner(cuda_device), "solve", solves, (3, 256)),
        (_vocoder(cuda_device), "vocode", mels, (3, 32))]
    for runner, call, reqs, key in stages:
        fn = getattr(runner, call)
        rows = _stack(reqs)
        one = fn(*reqs[0])
        want = fn(*rows, eager=True)
        for _ in range(2):
            assert torch.equal(fn(*rows), want)
        one_key = (1,) + key[1:]
        assert runner.keys() == {one_key: True, key: True}
        assert torch.equal(fn(*reqs[0]), one)
        fn(*_stack(reqs[:2]))  # a second batched key evicts the first only
        assert runner.keys() == {one_key: True, (2,) + key[1:]: True}


@pytest.mark.cuda
def test_batched_request_after_precompile_evicts_no_warmed_key(cuda_device):
    """A small engine on the card: precompile over an envelope of 24 codes;
    a batched request of 3 segments captures its own keys (B=3) and a
    decode state of 3 rows, evicts no warmed key, and gives the same audio
    again from its seed; a sequential request inside the envelope after it
    captures nothing."""
    import chip_smoke

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    cfg = chip_smoke.small_config()
    eng = IndexTTS2Engine(cfg, random_params(cfg, seed=0, device=cuda_device),
                          device=cuda_device)
    t = np.arange(16000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
           ).astype(np.float32)
    eng.precompile(eng.prepare_speaker(wav, 16000), text_buckets=[16],
                   max_code_len=cfg.runtime.max_mel_tokens)
    runners = (eng.latent_runner, eng.s2mel_runner, eng.vocoder_runner)
    warmed = [r.keys() for r in runners]
    segs = [np.arange(2, 14), np.arange(3, 8), np.arange(5, 16)]
    first = eng.infer((wav, 16000), segs, seed=0, batched=True)
    for r, keys in zip(runners, warmed):
        held = r.keys()
        assert all(held.get(k) for k in keys)
        assert [k[0] for k in held if k not in keys] == [3]
    assert (3, 256) in {k[:2] for k in eng.decoder._states}
    again = eng.infer((wav, 16000), segs, seed=0, batched=True)
    np.testing.assert_array_equal(again["audio"], first["audio"])
    before = chip_smoke.graph_counts(eng)
    out = eng.infer((wav, 16000), [np.arange(2, 14)], seed=0)
    assert chip_smoke.graph_counts(eng) == before
    assert np.isfinite(first["audio"]).all() and np.isfinite(out["audio"]).all()


# ---------------------------------------------------------------------------
# the keyed route (the conditioning prefix's KV reused) and the sequential
# tail overlap
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_keyed_prefill_matches_monolithic(cuda_device, route):
    """On the float, W8 and W4 GPTs (the quantized ones with the int8 KV
    cache), the keyed prefill's first-step logits and the float KV of the
    prompt's S slots against the monolithic prefill's
    (chip_smoke.keyed_prefill_errors): within 1e-4 of the largest |value|
    on float32, 1e-2 on W8/W4, where the noise may flip one int8 step of an
    activation row. Then the keyed route's captured decode gives its eager
    loop's codes."""
    import chip_smoke

    dec, (conds, *arrays) = _graph_decoder(cuda_device, route)
    assert dec.supports_cond_kv
    logit_err, kv_err = chip_smoke.keyed_prefill_errors(dec, conds, *arrays)
    tol = 1e-4 if route == "float" else 1e-2
    assert logit_err <= tol and kv_err <= tol, (logit_err, kv_err)
    prefix = dec.cond_prefill(conds)
    runs = [dec.generate(conds, *arrays, 3, max_new=40, eager=eager, cond_kv=prefix)
            for eager in (True, False, False)]
    assert all(torch.equal(r.codes, runs[0].codes) for r in runs[1:])


@pytest.mark.cuda
def test_overlap_captures_tails_beside_decode_replays(cuda_device, tmp_path, monkeypatch):
    """A small engine on the card with no graph captured, a path prompt
    (the keyed route, its caches read from the producer and tail threads):
    a 3-segment request on the pipelined route, where the first segment's
    tail captures the latent, s2mel and vocoder graphs while the next
    segment's decode replays the step its decode captured, gives the bits
    of the same request on the inline route, which captures nothing more.
    Then every graph captured replays under set_sync_debug_mode("error"),
    which raises on a host sync."""
    import chip_smoke

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    monkeypatch.delenv("TARS_STAGE_SYNC", raising=False)
    cfg = chip_smoke.small_config()
    eng = IndexTTS2Engine(cfg, random_params(cfg, seed=0, device=cuda_device),
                          device=cuda_device)
    path = str(tmp_path / "spk.wav")
    chip_smoke.speaker_wav(path)
    segs = [np.random.default_rng(n).integers(2, 50, n) for n in (9, 20, 31)]
    assert chip_smoke.graph_counts(eng) == (0, 0, 0, 0)
    piped = eng.infer(path, segs, seed=4)
    captured = chip_smoke.graph_counts(eng)
    assert captured == (1, 1, 1, 1)
    eng.cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, seq_tail_overlap=False))
    inline = eng.infer(path, segs, seed=4)
    assert chip_smoke.graph_counts(eng) == captured
    assert piped["audio"].size and np.isfinite(piped["audio"]).all()
    np.testing.assert_array_equal(piped["audio"], inline["audio"])
    assert len(eng._cond_kv_cache) == 1
    graphs = [(eng.decoder._stream, g) for st in eng.decoder._states.values()
              for g, _ in st.graphs.values()]
    graphs += [(r.stream, p.graph) for r in (eng.latent_runner, eng.s2mel_runner,
                                             eng.vocoder_runner)
               for p in r.programs.values()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for stream, graph in graphs:
            with torch.cuda.stream(stream):
                graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert len(graphs) == 4


@pytest.mark.cuda
def test_qwen_captured_step_matches_eager(cuda_device):
    """The Qwen3 decoder's captured step against its eager step on the card:
    the same greedy tokens (the same kernels on the same buffers), a graph
    for the capacity, replays that make no host sync; and the card's
    prefill logits within 1e-4 of the largest of the CPU's (float32, no
    TF32, summed in another order), its tokens the CPU's."""
    import copy

    from indextts_tpu_torch.config import QwenEmoConfig
    from indextts_tpu_torch.models.qwen3 import Qwen3LM, QwenDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = QwenEmoConfig(vocab_size=4096, hidden_size=256, num_hidden_layers=4,
                        num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                        intermediate_size=512)
    torch.manual_seed(15)
    cpu = Qwen3LM(cfg).eval().requires_grad_(False)
    cpu.model.embed_tokens.weight.mul_(0.01)  # the blocks pick the tokens, not the echo
    gpu = copy.deepcopy(cpu).to(cuda_device)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 37)
    dec = QwenDecoder(gpu)
    eager = dec.generate(ids, 48, -1, eager=True)
    assert dec._states[256].graph is None
    captured = dec.generate(ids, 48, -1)
    st = dec._states[256]
    assert st.graph is not None
    np.testing.assert_array_equal(captured, eager)
    np.testing.assert_array_equal(dec.generate(ids, 48, -1), eager)
    np.testing.assert_array_equal(QwenDecoder(cpu).generate(ids, 48, -1), eager)
    with torch.inference_mode():
        want, _ = cpu(torch.from_numpy(ids)[None], torch.arange(len(ids)))
        got, _ = gpu(torch.from_numpy(ids)[None].to(cuda_device),
                     torch.arange(len(ids), device=cuda_device))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(want.abs().max())
    with torch.inference_mode(), torch.cuda.stream(dec._stream):
        dec.prefill(st, ids)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(4):
                st.graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert int(st.pos) == len(ids) + 4


@pytest.mark.cuda
def test_load_engine_builds_on_the_card(cuda_device, tmp_path):
    """runtime/loader.py load_engine(dir) with no device: every tensor of
    every model on the card, the written weights (the weight-norm pairs
    folded within 1e-6 of the largest |value|), no model filled."""
    import chip_smoke
    from indextts_tpu_torch.runtime.engine import MODELS, random_params
    from indextts_tpu_torch.runtime.loader import load_engine

    cfg = chip_smoke.small_config()
    sds = random_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    vocab, rows, hs = cfg.gpt.number_text_tokens + 1, sum(cfg.emo_num), cfg.w2vbert.hidden_size
    chip_smoke.write_reference_dir(
        str(tmp_path), sds, (torch.randn((vocab, cfg.gpt.model_dim), generator=g),
                             torch.zeros(vocab)),
        (torch.zeros(hs), torch.ones(hs)), torch.randn((rows, cfg.gpt.model_dim), generator=g),
        torch.randn((rows, 192), generator=g), cfg.w2vbert.num_hidden_layers + 1)
    eng = load_engine(str(tmp_path), cfg=cfg)
    assert eng.device.type == "cuda" and eng.load_report.filled == []
    for name in MODELS:
        got = getattr(eng, name).state_dict()
        assert set(got) == set(sds[name])
        for key, want in sds[name].items():
            assert got[key].device.type == "cuda", (name, key)
            err = (got[key].cpu() - want).abs().max()
            assert err <= (1e-6 * want.abs().max() if chip_smoke.weight_normed(name, key)
                           else 0), (name, key)


# K9 and K10 (the backward of K3, csrc/dit_attention_bwd.cu) against
# autograd through the plain version, at K3's cases: partial masks, T=37
# below one tile, the main path's solve (T=898, 774 valid), a row with one
# valid key and a row with none (uniform softmax: a dV, no dQ or dK), the
# longest segment (T=2946, 2838 valid), a batched solve's 16 rows
# (chip_smoke.py's batch_dit_valid, cond and null halves alike) and a row
# whose valid keys are no prefix (a whole 128-key run masked between valid
# keys, chip_smoke.py `nonprefix_row`) beside a row with none. Both sum ~T
# float32 terms in other orders, the kernels in 3xTF32 over K3's row
# statistics: each gradient within 2e-5 of max(1, max|plain|).
K9_CASES = [(100, [100, 50]), (37, [37, 20]), (898, [774, 774]), (255, [255, 1]),
            (300, [300, 0]), (2946, [2838, 2838]), (898, "batched 16 rows"),
            (898, "non-prefix")]


def _k9_inputs(dev, T, lens):
    """q, k, v (seeded by T, as `_k3_inputs`), the key mask of `lens`
    (valid keys a row, or a named case of K9_CASES) and dout."""
    import chip_smoke
    from indextts_tpu_torch.config import load_config

    if lens == "batched 16 rows":
        lens = chip_smoke.main_path_shapes(load_config(), chip_smoke.MAX_MEL_TOKENS)[
            "batch_dit_valid"] * 2
    elif lens == "non-prefix":
        lens = ["non-prefix", 0]
    g = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn((len(lens), 8, T, 64), generator=g, device=dev) for _ in range(3))
    mask = chip_smoke.key_mask(T, lens)
    g = torch.Generator(device=dev).manual_seed(T + 1)
    return q, k, v, mask, torch.randn(q.shape, generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", K9_CASES)
def test_train_k9_k10_cuda_match_plain(cuda_device, T, lens):
    q, k, v, mask, dout = _k9_inputs(cuda_device, T, lens)
    out, stats = k3.dit_attention_stats(q, k, v, mask)
    assert torch.equal(out, k3.dit_attention(q, k, v, mask))
    counted = k3.bwd_dkv_counter.launches, k3.bwd_dq_counter.launches
    got = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    assert (k3.bwd_dkv_counter.launches, k3.bwd_dq_counter.launches) == (
        counted[0] + 1, counted[1] + 1)
    want = k3.dit_attention_bwd_plain(q, k, v, mask, dout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert (a - b).abs().max() <= 2e-5 * max(1.0, b.abs().max().item()), name
    for row in range(len(mask)):
        if not mask[row].any():
            assert not got[0][row].any() and not got[1][row].any()
            assert got[2][row].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [(898, [774, 774]), (898, "batched 16 rows"),
                                    (898, "non-prefix")])
def test_train_k9_k10_cuda_skip_masked_keys_exactly(cuda_device, T, lens):
    """In a row with a valid key, dK and dV are exactly 0 at every masked
    key (K9 skips the warps and blocks whose keys are all masked, K10 the
    key tiles without a valid key), and dQ is the plain version's within
    2e-5 of max(1, max|plain|)."""
    q, k, v, mask, dout = _k9_inputs(cuda_device, T, lens)
    out, stats = k3.dit_attention_stats(q, k, v, mask)
    dq, dk, dv = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    want = k3.dit_attention_bwd_plain(q, k, v, mask, dout)[0]
    assert (dq - want).abs().max() <= 2e-5 * max(1.0, want.abs().max().item())
    for row in range(len(mask)):
        if mask[row].any():
            assert not dk[row][:, ~mask[row]].any() and not dv[row][:, ~mask[row]].any(), row


@pytest.mark.cuda
def test_train_k9_k10_cuda_repeat_their_bits(cuda_device):
    q, k, v, mask, dout = _k9_inputs(cuda_device, 898, [774, 500])
    out, stats = k3.dit_attention_stats(q, k, v, mask)
    first = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    second = k3.dit_attention_bwd(q, k, v, mask, out, stats, dout)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _train_batches(cfg, target, seed=0):
    import numpy as np

    from indextts_tpu_torch import finetune

    rng = np.random.default_rng(seed)
    if target == "gpt":
        return finetune.synthetic_gpt_batch(cfg, 2, rng), None
    T, B = 300, 2
    d = cfg.s2mel.dit
    batch = {"x1": rng.standard_normal((B, d.in_channels, T)).astype(np.float32),
             "x_lens": np.array([T, 211], np.int32), "prompt_lens": np.array([30, 17], np.int32),
             "mu": rng.standard_normal((B, T, d.content_dim)).astype(np.float32),
             "style": rng.standard_normal((B, d.style_dim)).astype(np.float32)}
    noise = (rng.uniform(0, 1, B).astype(np.float32),
             rng.standard_normal((B, d.in_channels, T)).astype(np.float32),
             np.array([False, True]))
    return batch, noise


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["cfm", "gpt"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, target):
    """One AdamW step of make_cfm_train_step / make_train_step on the card
    (the DiT's attention through K3 with statistics, K9 and K10: one launch
    of each a DiT layer) against the same step on the CPU, from the same
    weights, batch and noise. Loss within 1e-5, gradients within 1e-4 of
    their largest |value|, and each parameter's distance from the CPU's
    within 1e-2 of the update's norm plus 1e-6 a element (Adam divides by
    the root mean square of each element's gradient, so elements whose
    gradient is rounding move up to lr either way; the GPT's key bias, whose
    gradient is zero in exact arithmetic, is left out)."""
    import chip_smoke
    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.runtime import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = chip_smoke.small_config()
    batch, noise = _train_batches(cfg, target)
    lr = 1e-3
    models, grads, losses = {}, {}, {}
    start = train.train_model(cfg, target, "cpu", seed=0).state_dict()
    for dev in (torch.device("cpu"), cuda_device):
        model = train.train_model(cfg, target, dev, start)
        opt = train.adamw(model.parameters(), lr)
        b = finetune.to_device(batch, dev)
        counted = (k3.counter.launches, k3.bwd_dkv_counter.launches,
                   k3.bwd_dq_counter.launches)
        if target == "gpt":
            step = train.make_train_step(model, opt)
            loss = step(b)
        else:
            step = train.make_cfm_train_step(model, opt)
            loss = step(b, noise=tuple(torch.from_numpy(x).to(dev) for x in noise))
        if dev.type == "cuda":
            n = cfg.s2mel.dit.depth if target == "cfm" else 0
            assert (k3.counter.launches, k3.bwd_dkv_counter.launches,
                    k3.bwd_dq_counter.launches) == tuple(c + n for c in counted)
        losses[dev.type] = loss.item()
        grads[dev.type] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        models[dev.type] = {k: v.cpu() for k, v in model.state_dict().items()}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    D = cfg.gpt.model_dim
    for name, want in grads["cpu"].items():
        assert (grads["cuda"][name] - want).abs().max() <= 1e-4 * max(
            want.abs().max().item(), 1e-30), name
        got, w, w0 = models["cuda"][name], models["cpu"][name], start[name]
        if target == "gpt" and name.endswith("attn.c_attn.bias"):
            got, w, w0 = (torch.cat([x[:D], x[2 * D:]]) for x in (got, w, w0))
        assert (got - w).norm() <= 1e-2 * (w - w0).norm() + 1e-6 * w.numel() ** 0.5, name

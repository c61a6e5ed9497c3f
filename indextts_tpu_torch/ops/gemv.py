"""Decode GEMVs and fused decode MLPs of the quantized GPT: W8A8 (kernels
K5, K6) and W4A8 (kernels K7, K8).

Counterparts of the JAX package's `gemv_w8`, `mlp_w8`, `gemv_w4` and
`mlp_w4` (indextts_tpu/ops/gemv.py `_gemv_kernel`, `_mlp_kernel`,
`_gemv4_kernel`, `_mlp4_kernel`), which the quantized GPT's single-row
decode calls take with `gemv_impl="pallas"`:

  gemv_w8  y(b,F) = (xq(b,D) . w(D,F)) * (a * s) + bias
  mlp_w8   out(b,D) = sum_g q8_g(gelu_new(xq . fc * (a*s1) + b1)) . fc2_g
                      * (ha_g * s2), + b2 with group 0, groups added in order
  gemv_w4  gemv_w8 over unpack_w4(wp(D/2,F), axis=0)
  mlp_w4   mlp_w8 over unpack_w4(fc(D/2,FH), axis=0) and
           unpack_w4(fc2(FH,D/2), axis=1), hidden groups of mlp_group_w4

xq is the int8 row from `_quant_row` with its per-row scale a; W8 weights
are int8 (D, F) row-major as the JAX tree stores them, with per-column f32
scales. W4 weights hold two int4 values per byte (`pack_w4`): the low
nibble is index i along the packed axis and the high nibble index i + n/2,
both signed. The MLP's fc is packed along its rows (the contraction) and
its fc2 along its output columns. The hidden of the MLP is quantized to
int8 per group of `mlp_group(D, FH)` (W8) or `mlp_group_w4(D, FH)` (W4)
columns, each group with its own absmax scale: that width is part of the
function (the JAX kernel's tile), not a tiling choice of the CUDA kernels,
so a tensor-parallel rank, which holds a slice of the hidden, passes the
whole MLP's width (`group`). The gating (`supports`, `supports_mlp`, `supports_w4`, `supports_mlp_w4`)
is the JAX package's.

The plain versions accumulate int8 x int8 exactly: in float64, which is exact
below 2^53 (127^2 x D is far below) and runs on both devices. The CUDA
kernels (csrc/gemv.cu) accumulate in int32 and do the float epilogue with the
same float32 operations in the same order, so on the card they equal the
plain versions to the bit. One of those operations is the MLP's group scale,
max / 127, a true division in the JAX kernels; PyTorch on CUDA would compute
a tensor over a Python scalar as a product with the scalar's float
reciprocal, so the plain versions divide by a tensor, on either device. The
wrappers run the kernel for CUDA tensors and the plain version for CPU
tensors.
"""

from __future__ import annotations

import functools

import torch

from indextts_tpu_torch.ops import cuda_lib

# the JAX kernels' target weight-tile bytes; they fix the MLP group widths
_TARGET_TILE_BYTES = 512 * 1024
_TARGET_TILE_BYTES_W4 = 256 * 1024
# decode rows one launch takes at most (the kernels' register accumulators);
# more rows go in chunks (`by_row_chunks`)
MAX_ROWS = 16
# the blocks of a cluster in the CUDA kernels
CLUSTER = 8
# K5/K7's launch plan (`gemv_plan`), which csrc/gemv.cu checks: the output
# columns a cluster may own, widest first; the weight bytes a block holds
# at once; the rows of a box (the copy engine's limit) and the boxes a
# block holds at once
GEMV_TILES = (256, 128, 64)
GEMV_PASS_BYTES = 96 * 1024
GEMV_MAX_BOX_ROWS = 256
GEMV_MAX_PASS_BOXES = 32


gemv_counter = cuda_lib.LaunchCounter()
mlp_counter = cuda_lib.LaunchCounter()
gemv4_counter = cuda_lib.LaunchCounter()
mlp4_counter = cuda_lib.LaunchCounter()


def _pick_block(d: int, f: int, max_blk: int = 1536,
                target: int = _TARGET_TILE_BYTES) -> int:
    """Largest multiple-of-128 divisor of f with d*blk closest to the byte
    target; 0 if f has none (indextts_tpu/ops/gemv.py `_pick_block`)."""
    best, best_cost = 0, None
    blk = 128
    while blk <= min(f, max_blk):
        if f % blk == 0:
            cost = abs(d * blk - target)
            if best_cost is None or cost < best_cost:
                best, best_cost = blk, cost
        blk += 128
    return best


def supports(d: int, f: int) -> bool:
    """Does a single-row W8A8 call on (d, f) take gemv_w8?"""
    return d % 32 == 0 and d >= 128 and _pick_block(d, f) > 0


def supports_mlp(d: int, fh: int) -> bool:
    """Does a single-row W8 MLP of widths (d, fh) take mlp_w8?"""
    return d % 128 == 0 and d >= 128 and fh % 32 == 0 and _pick_block(d, fh) > 0


def mlp_group(d: int, fh: int) -> int:
    """Width of mlp_w8's hidden activation-quantization group (512 at
    D=1280, FH=5120: ten groups)."""
    return _pick_block(d, fh)


def supports_w4(d: int, f: int) -> bool:
    """Does a single-row W4A8 call on (d, f) take gemv_w4?"""
    return d % 64 == 0 and d >= 256 and mlp_group_w4(d, f) > 0


def supports_mlp_w4(d: int, fh: int) -> bool:
    """Does a single-row W4 MLP of widths (d, fh) take mlp_w4?"""
    return d % 256 == 0 and d >= 256 and fh % 64 == 0 and mlp_group_w4(d, fh) > 0


def mlp_group_w4(d: int, fh: int) -> int:
    """Width of mlp_w4's hidden activation-quantization group: the W4
    kernel's tile over the d/2 packed rows at its own byte target. It
    equals mlp_group(d, fh), since both halve together."""
    return _pick_block(d // 2, fh, target=_TARGET_TILE_BYTES_W4)


def pack_w4(q: torch.Tensor, cols: bool = False) -> torch.Tensor:
    """int4 values in [-8, 7] -> int8 bytes, halving axis 1 (cols) or 0.
    Byte = (hi << 4) | (lo & 0xF) with lo = index i and hi = index i + n/2
    along the packed axis (indextts_tpu/models/gpt2.py `pack_w4`)."""
    q = q.to(torch.int32)
    lo, hi = q.chunk(2, dim=1 if cols else 0)
    return (hi * 16 + (lo & 0xF)).to(torch.int8)


def unpack_w4(wp: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Packed bytes -> int8 values in [-8, 7], doubling `axis`: the low
    nibbles, then the high ones, each sign-extended (the inverse of
    pack_w4; indextts_tpu/ops/gemv.py `unpack_w4`)."""
    w = wp.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    return torch.cat([lo, w >> 4], dim=axis).to(torch.int8)


def int8_sums(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 contraction over the last axis of xq and the first
    of w: the int32 sums, held exactly in float64."""
    return torch.matmul(xq.to(torch.float64), w.to(torch.float64))


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`int8_sums` as float32 (each int32 sum rounded once, as XLA's astype
    does)."""
    return int8_sums(xq, w).float()


def gelu_new_kernel_form(h: torch.Tensor) -> torch.Tensor:
    """gelu_new as the JAX mlp_w8 kernel writes it (h * h * h, not pow)."""
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))


def gemv_w8_plain(xq, a, w_q, w_scale, bias):
    """xq (b, D) int8; a (b,) or (b, 1) f32; w_q (D, F) int8; w_scale and
    bias (F,) f32. Returns (b, F) f32."""
    acc = int8_matmul(xq, w_q)
    return acc * (a.reshape(-1, 1).float() * w_scale) + bias


def gemv_w4_plain(xq, a, w_p, w_scale, bias):
    """gemv_w8_plain over w_p (D/2, F), packed along its rows."""
    return gemv_w8_plain(xq, a, unpack_w4(w_p, axis=0), w_scale, bias)


def mlp_w8_plain(xq, a, fc_q, fc_scale, fc_bias, fc2_q, fc2_scale, fc2_bias, group=0):
    """xq (b, D) int8; a (b,) or (b, 1); fc_q (D, FH) int8; fc2_q (FH, D)
    int8; scales and biases f32. Returns (b, D) f32. The hidden's groups
    are `group` columns wide, by default mlp_group(D, FH): a tensor-parallel
    rank, which holds a slice of the hidden, gives the whole MLP's."""
    hb = group or mlp_group(*fc_q.shape)
    return _mlp_plain(xq, a, fc_q, fc_scale, fc_bias, fc2_q, fc2_scale, fc2_bias, hb)


def mlp_w4_plain(xq, a, fc_p, fc_scale, fc_bias, fc2_p, fc2_scale, fc2_bias, group=0):
    """mlp_w8_plain over fc_p (D/2, FH), packed along its rows, and fc2_p
    (FH, D/2), packed along its columns: output columns j and j + D/2
    share a byte. The hidden's groups are `group` columns wide, by default
    mlp_group_w4(D, FH)."""
    d2, fh = fc_p.shape
    return _mlp_plain(xq, a, unpack_w4(fc_p, axis=0), fc_scale, fc_bias,
                      unpack_w4(fc2_p, axis=1), fc2_scale, fc2_bias,
                      group or mlp_group_w4(2 * d2, fh))


def _mlp_plain(xq, a, fc_q, fc_scale, fc_bias, fc2_q, fc2_scale, fc2_bias, hb):
    b, d = xq.shape
    fh = fc_q.shape[1]
    if hb == 0 or fh % hb:
        raise ValueError(f"the fused MLP's hidden of {fh} columns is not a whole number of "
                         f"groups (group {hb}, D={d})")
    n_groups = fh // hb
    h = int8_matmul(xq, fc_q) * (a.reshape(-1, 1).float() * fc_scale) + fc_bias
    h = gelu_new_kernel_form(h).reshape(b, n_groups, hb)
    # max / 127, divided (over a tensor: a Python scalar would make PyTorch
    # on CUDA multiply by its reciprocal); (b, G, 1)
    m = h.abs().amax(dim=-1, keepdim=True)
    ha = m / torch.full_like(m, 127.0) + 1e-12
    hq = torch.clamp(torch.round(h / ha), -127, 127)
    # (G, b, hb) x (G, hb, D): one exact int8 product per group
    acc = torch.bmm(hq.transpose(0, 1).to(torch.float64),
                    fc2_q.reshape(n_groups, hb, -1).to(torch.float64)).float()
    parts = acc * (ha.transpose(0, 1) * fc2_scale)
    out = parts[0] + fc2_bias
    for g in range(1, n_groups):
        out = out + parts[g]
    return out


def by_row_chunks(fn, rows: int, xq, a, *weights):
    """fn(xq, a, *weights) over chunks of at most `rows` decode rows,
    stacked. Each row's scale a, and in the fused MLPs its hidden groups,
    are its own, so the chunks give one call's rows to the bit."""
    n = xq.shape[0]
    if n <= rows:
        return fn(xq, a, *weights)
    a = a.reshape(-1)
    return torch.cat([fn(xq[i:i + rows], a[i:i + rows], *weights)
                      for i in range(0, n, rows)])


@functools.lru_cache(maxsize=None)
def mlp_rows(d: int, hb: int, w4: bool) -> int:
    """Decode rows one K6/K8 launch takes at width d with hidden groups of
    hb columns: MAX_ROWS, or fewer where a block's shared memory holds
    fewer; 0 where not even one row fits (csrc/gemv.cu `mlp_max_rows`)."""
    fn = cuda_lib.function("gemv", "mlp_max_rows", [cuda_lib.I] * 3)
    return fn(d, hb, int(w4))


@functools.lru_cache(maxsize=None)
def gemv_plan(rows: int, f: int, sms: int) -> tuple:
    """K5's and K7's launch over an int8 (rows, f) weight (W4: its packed
    rows) on a card of `sms` SMs: (tile, box_rows, pass_boxes).

    A cluster of CLUSTER blocks owns `tile` output columns, the widest of
    GEMV_TILES whose ceil(f / tile) clusters give every SM a block (else
    the narrowest); the last tile may run past f. Block k of a cluster
    contracts the k-th CLUSTER-th of the rows as boxes of box_rows rows,
    the largest multiple of 4 that divides them and fits a box (one box
    up to 256 rows a block: D=2048 under W8, D=4096 under W4), pass_boxes
    at a time: all of them, in passes only past GEMV_PASS_BYTES a block.
    The JAX gates keep rows a multiple of 4 * CLUSTER; other rows raise."""
    if rows <= 0 or rows % (4 * CLUSTER) or f <= 0:
        raise ValueError(f"gemv_plan: rows {rows} must be a positive multiple of "
                         f"{4 * CLUSTER}, and f {f} positive")
    tile = next((t for t in GEMV_TILES if -(-f // t) * CLUSTER >= sms), GEMV_TILES[-1])
    block_rows = rows // CLUSTER
    box = min(GEMV_MAX_BOX_ROWS, GEMV_PASS_BYTES // tile, block_rows) // 4 * 4
    while block_rows % box:
        box -= 4
    pass_boxes = min(block_rows // box, GEMV_PASS_BYTES // (box * tile), GEMV_MAX_PASS_BOXES)
    return tile, box, pass_boxes


def _f32(t):
    """t as a contiguous float32 tensor: t itself where it is one already
    (a conversion call costs about a microsecond of host time even when it
    has nothing to do, on every decode call of K5-K8)."""
    return t if t.dtype is torch.float32 and t.is_contiguous() else t.float().contiguous()


def _check(name, xq, tensors, d):
    if xq.dtype != torch.int8 or xq.dim() != 2 or xq.shape[1] != d or xq.shape[0] < 1:
        raise ValueError(f"{name}: xq must be int8 (b, {d}), got {xq.dtype} {tuple(xq.shape)}")
    for t in tensors:
        if t.device != xq.device:
            raise ValueError(f"{name}: all inputs must be on the same device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def gemv_w8(xq, a, w_q, w_scale, bias):
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    if xq.device.type == "cpu":
        return gemv_w8_plain(xq, a, w_q, w_scale, bias)
    d, f = w_q.shape
    return _launch_gemv("gemv_w8", gemv_counter, xq, a, w_q, w_scale, bias, d, f)


def gemv_w4(xq, a, w_p, w_scale, bias):
    """K7 on CUDA tensors, the plain version on CPU tensors. w_p (D/2, F)
    is packed along its rows."""
    if xq.device.type == "cpu":
        return gemv_w4_plain(xq, a, w_p, w_scale, bias)
    d2, f = w_p.shape
    return _launch_gemv("gemv_w4", gemv4_counter, xq, a, w_p, w_scale, bias, 2 * d2, f)


def _launch_gemv(symbol, counter, xq, a, w, w_scale, bias, d, f):
    """The C entry point `symbol`(xq, a, w, s, bias, y, b, D, F, tile,
    box_rows, pass_boxes, stream), one launch for every MAX_ROWS rows, on
    `gemv_plan`; D is the contraction width, whatever w's packing."""
    if w.dtype != torch.int8 or f % 16:
        raise ValueError(f"{symbol}: weight must be int8 with F a multiple of 16, "
                         f"got {w.dtype} {tuple(w.shape)}")
    a, w_scale, bias, xq = _f32(a), _f32(w_scale), _f32(bias), xq.contiguous()
    _check(symbol, xq, (a, w, w_scale, bias), d)
    b = xq.shape[0]
    if a.numel() != b or w_scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"{symbol}: scale or bias shape does not match")
    plan = gemv_plan(w.shape[0], f, cuda_lib.sm_count(xq.device.index))
    fn = cuda_lib.function("gemv", symbol, [cuda_lib.P] * 6 + [cuda_lib.I] * 6 + [cuda_lib.P])
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    return by_row_chunks(_gemv_once, MAX_ROWS, xq, a, w, w_scale, bias,
                         fn, symbol, counter, stream, d, f, plan)


def _gemv_once(xq, a, w, w_scale, bias, fn, symbol, counter, stream, d, f, plan):
    """One launch of K5 or K7 over at most MAX_ROWS rows."""
    b = xq.shape[0]
    out = torch.empty((b, f), device=xq.device, dtype=torch.float32)
    err = fn(xq.data_ptr(), a.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(), b, d, f, *plan, stream)
    cuda_lib.check(err, f"{symbol} (D={d}, F={f}, {b} rows, plan {plan})")
    counter.add()
    return out


def mlp_w8(xq, a, fc_q, fc_scale, fc_bias, fc2_q, fc2_scale, fc2_bias, group=0):
    """K6 on CUDA tensors, the plain version on CPU tensors; the hidden's
    groups as mlp_w8_plain's. On the card a launch takes 16 rows up to
    D=2304 at FH=4*D, fewer past that (a block's shared memory,
    `mlp_rows`); more rows go in chunks."""
    if xq.device.type == "cpu":
        return mlp_w8_plain(xq, a, fc_q, fc_scale, fc_bias, fc2_q, fc2_scale, fc2_bias, group)
    d, fh = fc_q.shape
    hb = group or mlp_group(d, fh)
    if not supports_mlp(d, fh) or fh % hb or fc2_q.shape != (fh, d):
        raise ValueError(f"mlp_w8: weights {tuple(fc_q.shape)} and {tuple(fc2_q.shape)} "
                         f"are not a supported (D, FH) and (FH, D) in groups of {hb}")
    return _launch_mlp("mlp_w8", mlp_counter, xq, a, fc_q, fc_scale, fc_bias,
                       fc2_q, fc2_scale, fc2_bias, d, fh, hb)


def mlp_w4(xq, a, fc_p, fc_scale, fc_bias, fc2_p, fc2_scale, fc2_bias, group=0):
    """K8 on CUDA tensors, the plain version on CPU tensors. fc_p (D/2, FH)
    is packed along its rows, fc2_p (FH, D/2) along its columns; the
    hidden's groups as mlp_w4_plain's. On the card a launch takes 16 rows
    up to D=3200 at FH=4*D, fewer past that, and more rows go in chunks, as
    in mlp_w8."""
    if xq.device.type == "cpu":
        return mlp_w4_plain(xq, a, fc_p, fc_scale, fc_bias, fc2_p, fc2_scale, fc2_bias, group)
    d2, fh = fc_p.shape
    d = 2 * d2
    hb = group or mlp_group_w4(d, fh)
    if not supports_mlp_w4(d, fh) or fh % hb or fc2_p.shape != (fh, d2):
        raise ValueError(f"mlp_w4: packed weights {tuple(fc_p.shape)} and "
                         f"{tuple(fc2_p.shape)} are not a supported (D/2, FH) and (FH, D/2) "
                         f"in groups of {hb}")
    return _launch_mlp("mlp_w4", mlp4_counter, xq, a, fc_p, fc_scale, fc_bias,
                       fc2_p, fc2_scale, fc2_bias, d, fh, hb)


_arrived = {}


def _arrival_counters(device, stream):
    """The fused MLP kernels' counters of finished groups, one per output
    span of a cluster's block, for `stream`, the current stream of
    `device`. Made and zeroed by the stream's first call; every call
    leaves them at zero, so the calls on one stream share them, and a CUDA
    graph captured on the stream replays with them. Streams do not share
    them, so calls on concurrent streams do not meet. The first call on a
    stream must not be under graph capture, which would record the zeroing
    without running it: warm up on the stream the graph is then captured
    on."""
    key = (device.index, stream.cuda_stream)
    t = _arrived.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused MLP: first call on this stream is under CUDA graph "
                               "capture; call it once on the capture stream before capturing")
        t = _arrived[key] = torch.zeros(CLUSTER, dtype=torch.int32, device=device)
    return t


def _launch_mlp(symbol, counter, xq, a, fc, fc_scale, fc_bias, fc2, fc2_scale, fc2_bias,
                d, fh, hb):
    """The C entry point `symbol`, one launch for every `mlp_rows` rows,
    each over a scratch of the groups' float partials, (G - 1, b, D)."""
    stream = torch.cuda.current_stream(xq.device)
    arrived = _arrival_counters(xq.device, stream)
    if hb % (16 * CLUSTER) or fc.dtype != torch.int8 or fc2.dtype != torch.int8:
        raise ValueError(f"{symbol}: int8 weights with groups of a multiple of "
                         f"{16 * CLUSTER} columns needed, got {fc.dtype}, "
                         f"{fc2.dtype}, group {hb}")
    a, xq = _f32(a), xq.contiguous()
    vecs = [_f32(t) for t in (fc_scale, fc_bias, fc2_scale, fc2_bias)]
    _check(symbol, xq, (a, fc, fc2, *vecs), d)
    b = xq.shape[0]
    if a.numel() != b or [v.shape[0] for v in vecs] != [fh, fh, d, d]:
        raise ValueError(f"{symbol}: scale or bias shape does not match")
    rows = mlp_rows(d, hb, symbol == "mlp_w4")
    if rows == 0:
        raise ValueError(f"{symbol}: one row at D={d}, FH={fh} exceeds a block's shared memory")
    fn = cuda_lib.function("gemv", symbol, [cuda_lib.P] * 11 + [cuda_lib.I] * 4 + [cuda_lib.P])
    return by_row_chunks(_mlp_once, rows, xq, a, fc, fc2, vecs, arrived,
                         fn, symbol, counter, stream.cuda_stream, d, fh, hb)


def _mlp_once(xq, a, fc, fc2, vecs, arrived, fn, symbol, counter, stream, d, fh, hb):
    """One launch of K6 or K8 over at most `mlp_rows` rows."""
    b = xq.shape[0]
    parts = torch.empty((max(fh // hb - 1, 1), b, d), device=xq.device, dtype=torch.float32)
    out = torch.empty((b, d), device=xq.device, dtype=torch.float32)
    err = fn(xq.data_ptr(), a.data_ptr(), fc.data_ptr(), vecs[0].data_ptr(),
             vecs[1].data_ptr(), fc2.data_ptr(), vecs[2].data_ptr(), vecs[3].data_ptr(),
             parts.data_ptr(), arrived.data_ptr(), out.data_ptr(), b, d, fh, hb, stream)
    cuda_lib.check(err, f"{symbol} (D={d}, FH={fh}, {b} rows)")
    counter.add()
    return out

"""Anti-aliased SnakeBeta: 2x kaiser-sinc upsample -> snake -> 2x kaiser-sinc
downsample, replicate padding (kernel K2).

Layout (B, C, T), as torch's Conv1d gives it. The CUDA kernel
(csrc/snake.cu) replaces the JAX package's Pallas kernels
(indextts_tpu/ops/snake_pallas.py `_kernel`, `_kernel_t`);
`anti_alias_snake_plain` is the polyphase algebra of the JAX package's
`anti_alias_snake_sliced` in plain PyTorch, which the wrapper runs for CPU
tensors. `snake_plan` is the kernel's launch, worked out here and checked
by the C launcher; `kernel_taps` the taps it takes by value.

x may be float32 or bfloat16 (a bfloat16 vocoder, runtime.voc_dtype): the
output has x's dtype, and the arithmetic is float32-class either way,
alpha and beta widened to float32, as the JAX package's Pallas kernels
upcast them (indextts_tpu/ops/snake_pallas.py:250-255, 309-313). A
bfloat16 x takes K2-bf16 (`anti_alias_snake_bf16`, counted on
`bf16_counter`), a kernel of its own with both FIRs on the tensor cores,
which reads a bfloat16 model's alpha and beta as they are stored (or
float32 ones), so a call stays one launch; its plain version widens x,
computes and rounds once. `band_taps` are the banded tap matrices it
multiplies by (`band_fragments` as it takes them) and `snake_bf16_plan`
its launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.ops import cuda_lib


counter = cuda_lib.LaunchCounter()  # the float32 instantiation's launches
bf16_counter = cuda_lib.LaunchCounter()  # the bfloat16 instantiation's


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """filter.py:30-62 semantics; returns (kernel_size,) float32, sum = 1."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt = filt / filt.sum()
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=1)
def polyphase_taps() -> Tuple[List[float], List[float], List[float]]:
    """(even, odd, down) taps of the 12-tap 2x filter: up[2t] uses
    even[m] * x[t - 3 + m], up[2t+1] uses odd[m] * x[t - 2 + m]."""
    f = kaiser_sinc_filter1d(0.5 / 2, 0.6 / 2, 12)
    even = [float(f[11 - 2 * m]) for m in range(6)]
    odd = [float(f[10 - 2 * m]) for m in range(6)]
    down = [float(w) for w in f]
    return even, odd, down


def anti_alias_snake_plain(x, alpha, beta, logscale: bool = True):
    """x (B, C, T); alpha, beta (C,), all of one dtype (float32 on the
    path). Returns (B, C, T)."""
    even_taps, odd_taps, down_taps = polyphase_taps()
    T = x.shape[-1]
    n_up = T + 6
    xg = F.pad(x, (8, 8), mode="replicate")
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    a = alpha[None, :, None]
    inv = 1.0 / (beta[None, :, None] + 1e-9)

    def fir(start, taps):
        acc = taps[0] * xg[..., start:start + n_up]
        for m in range(1, 6):
            acc = acc + taps[m] * xg[..., start + m:start + m + n_up]
        return acc

    def snake(u):
        s = torch.sin(u * a)
        return u + inv * s * s

    up_even = snake(2.0 * fir(2, even_taps))
    up_odd = snake(2.0 * fir(3, odd_taps))
    # edge clamp of the up signal: up[m<0] := up[0], up[m>2T-1] := up[2T-1]
    g = torch.arange(n_up, device=x.device) - 3
    row0 = up_even[..., 3:4]
    row_t = up_odd[..., T + 2:T + 3]
    lo, hi = g < 0, g > T - 1
    up_even = torch.where(lo, row0, torch.where(hi, row_t, up_even))
    up_odd = torch.where(lo, row0, torch.where(hi, row_t, up_odd))
    acc = None
    for j, w in enumerate(down_taps):
        ofs = j - 5
        phase = ofs & 1
        per = (ofs - phase) // 2
        src = up_odd if phase else up_even
        term = w * src[..., per + 3:per + 3 + T]
        acc = term if acc is None else acc + term
    return acc


SNAKE_WARPS = 4  # warps a block: csrc/snake.cu kWarps
SNAKE_LANE_OUTPUTS = 12  # R, the consecutive outputs a lane holds in registers


def snake_plan(B: int, C: int, T: int) -> Tuple[int, int, int]:
    """K2's launch over x (B, C, T): (R, chunks, blocks).

    A warp takes a chunk of 32 * R consecutive outputs of one row, lane l
    the R from l * R; a row takes chunks = ceil(T / (32 R)) warps, of which
    only the last runs past T (its lanes past T store nothing), so at most
    one warp's chunk a row is idle. Warp w takes chunk w % chunks of row
    w // chunks (row = b * C + c), SNAKE_WARPS warps a block: blocks =
    ceil(B * C * chunks / SNAKE_WARPS), of which only the last may hold
    warps past the rows (they return)."""
    if B < 1 or C < 1 or T < 1:
        raise ValueError(f"anti_alias_snake: x must be non-empty, got ({B}, {C}, {T})")
    r = SNAKE_LANE_OUTPUTS
    chunks = -(-T // (32 * r))
    return r, chunks, -(-B * C * chunks // SNAKE_WARPS)


@functools.lru_cache(maxsize=1)
def kernel_taps() -> Tuple[float, ...]:
    """The kernel's 24 taps: even and odd times the up FIR's gain of 2,
    then down. Folding the gain is exact: a product or sum of float32
    values times 2 is the product or sum of the values with one of them
    doubled, rounded alike, away from overflow and subnormals."""
    even, odd, down = polyphase_taps()
    return tuple([2.0 * t for t in even + odd] + down)


@functools.lru_cache(maxsize=1)
def _taps_arg() -> ctypes.Array:
    return (ctypes.c_float * 24)(*kernel_taps())


SNAKE_BF16_WARPS = 4  # warps a block of K2-bf16: csrc/snake.cu kBWarps
SNAKE_BF16_BLOCKS = 4  # its blocks an SM: kBMinBlocks
SNAKE_BF16_ROWS = 16  # rows (B * C flattened) a tile: the mma's M
SNAKE_BF16_BOX = 64  # time positions a TMA box: kBox
# steps (8 outputs each) a segment costs beyond its own: the pair block
# before its first output block, the chunk loads outside its boxes, the
# row's alpha and beta
SNAKE_BF16_ITEM_STEPS = 4


@functools.lru_cache(maxsize=1)
def band_matrices() -> np.ndarray:
    """K2-bf16's four banded Toeplitz matrices, float32 (4, 16, 8) (k x n),
    in `kernel_taps`' values (the up gain folded in):

    - 0, 1: the up FIR's even and odd phase. Row k is x[8q - 8 + k] of a
      window of 16 inputs, column n the pair 8q - 4 + n (up[2p] = sum
      even[m] x[p - 3 + m], up[2p + 1] = sum odd[m] x[p - 2 + m]).
    - 2, 3: the down FIR over pair block q = b and q = b + 1 (pairs 8q - 4
      + i) of output block b (outputs 8b + n): row k < 8 the even sample
      of pair i = k, row k >= 8 the odd sample of pair i = k - 8, with
      out[t] = sum down[j] up[2t + j - 5]."""
    taps = kernel_taps()
    even, odd, down = taps[:6], taps[6:12], taps[12:]
    m = np.zeros((4, 16, 8), np.float32)
    for k in range(16):
        for n in range(8):
            if 0 <= k - n - 1 < 6:
                m[0, k, n] = even[k - n - 1]
            if 0 <= k - n - 2 < 6:
                m[1, k, n] = odd[k - n - 2]
            for i, d in ((2, -4), (3, 4)):  # pair 8q - 4 lies d from output 8b
                j = 2 * (d + k - n) + 5 if k < 8 else 2 * (d + k - 8 - n) + 6
                if 0 <= j < 12:
                    m[i, k, n] = down[j]
    return m


@functools.lru_cache(maxsize=1)
def band_taps() -> np.ndarray:
    """The bits of `band_matrices` split hi + lo (each rounded to bfloat16
    to nearest even, hi + lo within 2^-17 of the tap), uint16 (8, 16, 8) in
    the order even hi, even lo, odd hi, odd lo, left hi, left lo, right hi,
    right lo."""
    m = torch.from_numpy(band_matrices())
    hi = m.bfloat16()
    lo = (m - hi.float()).bfloat16()
    bits = torch.stack([hi, lo], 1).reshape(8, 16, 8).view(torch.int16).numpy()
    return bits.view(np.uint16)


@functools.lru_cache(maxsize=1)
def band_fragments() -> np.ndarray:
    """`band_taps` as the kernel takes them (csrc/snake.cu `Band`): uint32
    (8, 32, 2), the B fragment of mma.m16n8k16 of each matrix for each
    lane (g, c) = (lane // 4, lane % 4): rows 2c, 2c + 1, then 2c + 8, 2c +
    9 of column g, the lower row in the low 16 bits."""
    m = band_taps().astype(np.uint32)
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    return np.stack([m[:, 2 * c + 8 * h, g] | m[:, 2 * c + 1 + 8 * h, g] << 16
                     for h in (0, 1)], -1)


@functools.lru_cache(maxsize=1)
def _band_arg() -> ctypes.Array:
    return (ctypes.c_uint32 * (8 * 32 * 2))(*band_fragments().ravel().tolist())


@functools.lru_cache(maxsize=None)
def snake_bf16_plan(B: int, C: int, T: int, sms: int,
                    blocks_per_sm=None) -> Tuple[int, int, int, int]:
    """K2-bf16's launch over x (B, C, T) on a card of `sms` SMs: (L,
    segs, items, blocks). `blocks_per_sm` (default SNAKE_BF16_BLOCKS, the
    kernel's) for a build of other occupancy (tools/snake_times.py).

    Rows (B * C flattened) go in tiles of 16; a row's T outputs in segs =
    ceil(T / L) segments of L (a multiple of the 64-position box), the
    last one shorter. Item i is tile i // segs, segment i % segs. The
    grid's warps (blocks of SNAKE_BF16_WARPS, at most SNAKE_BF16_BLOCKS a
    SM, none without an item) are persistent: warp w takes items w, w + W,
    ... L is the one whose busiest warp walks the fewest steps, each item
    SNAKE_BF16_ITEM_STEPS steps more than its outputs' blocks of 8; a tie
    takes the longer L."""
    if B < 1 or C < 1 or T < 1:
        raise ValueError(f"anti_alias_snake: x must be non-empty, got ({B}, {C}, {T})")
    tiles = -(-B * C // SNAKE_BF16_ROWS)
    per_sm = blocks_per_sm or SNAKE_BF16_BLOCKS
    warps = sms * per_sm * SNAKE_BF16_WARPS
    box = SNAKE_BF16_BOX
    best = None
    for L in range(box, -(-T // box) * box + 1, box):
        segs = -(-T // L)
        cost = -(-tiles * segs // warps) * (-(-min(L, T) // 8) + SNAKE_BF16_ITEM_STEPS)
        if best is None or cost <= best[0]:
            best = (cost, L, segs)
    _, L, segs = best
    items = tiles * segs
    return L, segs, items, min(-(-items // SNAKE_BF16_WARPS), sms * per_sm)


def bf16_attributes() -> dict:
    """K2-bf16's compiled registers and local (spill) bytes a thread on the
    current card: {(tma, alpha/beta dtype): (regs, local)}."""
    out = (ctypes.c_int * 8)()
    fn = cuda_lib.function("snake", "anti_alias_snake_bf16_attributes", [cuda_lib.P])
    cuda_lib.check(fn(ctypes.addressof(out)), "anti_alias_snake_bf16_attributes")
    keys = [(True, "bfloat16"), (False, "bfloat16"), (True, "float32"), (False, "float32")]
    return {k: (out[2 * i], out[2 * i + 1]) for i, k in enumerate(keys)}


def anti_alias_snake(x, alpha, beta, logscale: bool = True):
    """K2 on CUDA tensors, the plain version on CPU tensors. x (B, C, T)
    float32 or bfloat16, the output of its dtype; alpha, beta (C,) of any
    float dtype, read as float32."""
    if x.device.type == "cpu":
        return anti_alias_snake_plain(x.float(), alpha.float(), beta.float(),
                                      logscale).to(x.dtype)
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    B, C, T = x.shape
    if alpha.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"alpha/beta must be ({C},)")
    if x.dtype not in (torch.float32, torch.bfloat16) or not alpha.is_floating_point() \
            or not beta.is_floating_point():
        raise TypeError(f"x float32 or bfloat16, alpha/beta float, got "
                        f"{x.dtype}/{alpha.dtype}/{beta.dtype}")
    if alpha.device != x.device or beta.device != x.device:
        raise ValueError("all inputs must be on the same device")
    bf16 = x.dtype == torch.bfloat16
    # the bf16 instantiation reads alpha and beta as bfloat16 or float32
    ab_bf16 = bf16 and alpha.dtype == beta.dtype == torch.bfloat16
    if not ab_bf16:
        alpha, beta = alpha.float(), beta.float()
    x, alpha, beta = x.contiguous(), alpha.contiguous(), beta.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        symbol = "anti_alias_snake_bf16"
        plan = snake_bf16_plan(B, C, T, cuda_lib.sm_count(x.device.index or 0))
        fn = cuda_lib.function("snake", symbol, [cuda_lib.P] * 5 + [cuda_lib.I] * 9 + [cuda_lib.P])
        err = fn(x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), ctypes.addressof(_band_arg()),
                 out.data_ptr(), B, C, T, int(logscale), *plan, int(ab_bf16), stream)
    else:
        symbol = "anti_alias_snake"
        vec = T % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
        fn = cuda_lib.function("snake", symbol, [cuda_lib.P] * 5 + [cuda_lib.I] * 8 + [cuda_lib.P])
        err = fn(x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), ctypes.addressof(_taps_arg()),
                 out.data_ptr(), B, C, T, int(logscale), *snake_plan(B, C, T), int(vec), stream)
    cuda_lib.check(err, symbol)
    (bf16_counter if bf16 else counter).add()
    return out

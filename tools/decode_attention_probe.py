#!/usr/bin/env python3
"""Where the device time of a K1/K4 call goes (the PyTorch port's decode
attention, indextts_tpu_torch/csrc/decode_attention.cu `decode_kernel`),
on one NVIDIA GPU:

  PYTHONPATH=. python3 tools/decode_attention_probe.py

1. Variants: the kernel rebuilt with other bulk-copy sizes (keys a copy,
   `kCopy`) and with parts cut out (their results are then wrong; for
   timing only): the bulk copies, the cluster combine, both, and a kernel
   of the same launch that returns at once. Each variant runs K1 over a
   float32 cache and K4 over an int8 one at the main path's last step (cap
   383) and at cap 1657 with valid 1657 and 400. Times are chip_smoke.py's:
   CUDA events over replays of a CUDA graph of calls that cycle more than
   100 MB of caches.
2. Timeline: the kernel rebuilt so that thread 0 of every block reads the
   global timer (%globaltimer, ns; it steps by up to 256 ns on an H100) at
   12 points (MARKS); one call with the L2 flushed, five times; printed is
   each point's median over the blocks (the median of the five calls), in
   ns from the first block's start, and the latest block's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from indextts_tpu_torch.models.gpt2 import quantize_kv
from indextts_tpu_torch.ops import cuda_lib
from indextts_tpu_torch.ops import decode_attention as da

COPY = "constexpr int kCopy = 128;"
CLUSTER = "  cg::cluster_group cluster = cg::this_cluster();\n"
CUTS = {
    "copies": [("  mbar_expect_tx(bar, bytes);\n  bulk_load(dst, src, bytes, bar);",
                "  mbar_expect_tx(bar, 0);")],
    "cluster combine": [
        ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");\n', ""),
        ('  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n', ""),
        ("    const uint32_t to = rank_addr(recv + rank * kPart, 0), bar = rank_addr(&landed, 0);\n"
         "    store_remote(to + (kAcc + tid) * 4, acc_run, bar);\n",
         "    recv[rank * kPart + kAcc + tid] = acc_run;\n"),
        ("      store_remote(to, m_run, bar);\n      store_remote(to + 4, l_run, bar);\n",
         "      recv[rank * kPart] = m_run;\n      recv[rank * kPart + 1] = l_run;\n"),
        ("    mbar_wait_cluster(&landed);\n", "")],
}
VARIANTS = {
    **{f"copies of {n} keys": [(COPY, f"constexpr int kCopy = {n};")] for n in (32, 64, 256)},
    **{f"without the {k}": v for k, v in CUTS.items()},
    "without copies and combine": CUTS["copies"] + CUTS["cluster combine"],
    "returns at once": [(CLUSTER, "  if (rk > 0) return;\n" + CLUSTER)],
}
# the timeline's points: (name, the line in the source it follows)
MARKS = [
    ("start", None),
    ("share known", "  rank_span(vl, cap, rank, start, end);\n"),
    ("copies asked", "  if (tid < kDh / 4) qs[tid] = qv;\n  __syncthreads();\n"),
    ("K landed", "      mbar_wait(&kbar[tid / kCopy], parity);\n"),
    ("softmax done", "    const float alpha = M == -INFINITY ? 1.f : exp2f(m_run - M);\n"
                     "    __syncthreads();\n"),
    ("V landed", "    for (int c = 0; c * kCopy < nr; ++c) mbar_wait(&vbar[c], parity);\n"),
    ("P.V done", "    *reinterpret_cast<float4*>(&red[row * kDh + c4]) = a;\n"
                 "    __syncthreads();\n"),
    ("rounds done", "      if (k_lane || v_lane) request(r0 + rk);\n    }\n  }\n"),
    ("cluster started", '  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n'),
    ("partial sent", "      store_remote(to + 4, l_run, bar);\n    }\n  }\n"),
    ("rank 0: all landed", "    mbar_wait_cluster(&landed);\n"),
    ("end", "    out[bh * kDh + tid] = A / fmaxf(Lsum, 1e-30f);\n  }\n"),
]
TIMER = """
__device__ long long g_marks[4096][16];
EXPORT int read_marks(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks));
}
EXPORT int clear_marks() {
  void* p;
  cudaGetSymbolAddress(&p, g_marks);
  return (int)cudaMemset(p, 0, sizeof(g_marks));
}
#define MARK(i)                                                         \\
  if (threadIdx.x == 0) {                                               \\
    long long t;                                                        \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));               \\
    g_marks[blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)][i] = t; \\
  }
"""
POINTS = [(383, 383), (1657, 1657), (1657, 400)]
HEADS, LAYERS = 20, 24


def edited(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"decode_attention_probe: pattern not in the source: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def timed_source(src: str) -> str:
    """The source with MARK(i) after each point of MARKS."""
    first = "  const size_t bh = (size_t)b * H + h;\n"
    pairs = [('#include "common.cuh"\n', '#include "common.cuh"\n' + TIMER),
             (first, "  MARK(0);\n" + first)]
    pairs += [(line, f"{line}MARK({i});\n") for i, (_, line) in enumerate(MARKS) if line]
    return edited(src, pairs)


def build_variants():
    """One nvcc per variant, all started together; their libraries."""
    src = (cuda_lib.CSRC / "decode_attention.cu").read_text()
    out = cuda_lib.build_dir() / "decode_attention_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    sources = {name: edited(src, pairs) for name, pairs in VARIANTS.items()}
    sources["timeline"] = timed_source(src)
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"whole kernel": cuda_lib.load("decode_attention")}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"decode_attention_probe: {name} did not build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entries(lib):
    k1 = lib.ragged_decode_attention
    k1.argtypes = [cuda_lib.P] * 7 + [cuda_lib.I] * 5 + [cuda_lib.F, cuda_lib.P]
    k4 = lib.ragged_decode_attention_q8
    k4.argtypes = [cuda_lib.P] * 9 + [cuda_lib.I] * 4 + [cuda_lib.F, cuda_lib.P]
    for fn in (k1, k4):
        fn.restype = cuda_lib.I
    return k1, k4


def caller(fn, q8: bool):
    """A call of C entry `fn` as the wrapper makes it."""
    def call(q, *rest):
        cache, ints = rest[:-3], rest[-3:]
        B, H, cap = cache[0].shape[:3]
        out = torch.empty((B, H, 64), device="cuda")
        ptrs = [t.data_ptr() for t in (q, *cache, *ints, out)]
        stream = torch.cuda.current_stream().cuda_stream
        rk = da.round_keys(cap, 64 * cache[0].element_size())
        if q8:
            err = fn(*ptrs, B, H, cap, rk, da.SCALE, stream)
        else:
            err = fn(*ptrs, B, H, cap, rk, 0, da.SCALE, stream)
        cuda_lib.check(err, "decode_attention_probe")
        return out
    return call


def cases(g):
    """Per (label, q8, cap, valid): the cycled argument tuples."""
    i32 = dict(dtype=torch.int32, device="cuda")
    out = []
    for q8 in (False, True):
        for cap, valid in POINTS:
            layer = 2 * HEADS * cap * (68 if q8 else 256)
            q = torch.randn((1, HEADS, 64), generator=g, device="cuda")
            ints = (torch.tensor([valid], **i32), torch.zeros(1, **i32), torch.zeros(1, **i32))
            args = []
            for _ in range(cs.cycle_copies(layer, LAYERS)):
                k, v = (torch.randn((1, HEADS, cap, 64), generator=g, device="cuda")
                        for _ in range(2))
                if q8:
                    (k8, ksc), (v8, vsc) = quantize_kv(k), quantize_kv(v)
                    args.append((q, k8, v8, ksc, vsc, *ints))
                else:
                    args.append((q, k, v, *ints))
            out.append((f"{'K4' if q8 else 'K1'} cap={cap} valid={valid}", q8, args))
    return out


def timeline(lib, call, args, flush):
    """Per point of MARKS: the median over the blocks and the latest block,
    in ns from the first block's start, each the median of five calls."""
    calls = []
    for i in range(5):
        flush.add_(1.0)  # evicts the caches from L2
        cuda_lib.check(lib.clear_marks(), "clear_marks")
        call(*args[i % len(args)])
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (4096 * 16))()
        cuda_lib.check(lib.read_marks(buf), "read_marks")
        t = np.frombuffer(buf, dtype=np.int64).reshape(4096, 16)[:, :len(MARKS)].astype(float)
        t = t[t[:, 0] > 0]
        t = np.where(t > 0, t - t[:, 0].min(), np.nan)
        calls.append(np.stack([np.nanmedian(t, axis=0), np.nanmax(t, axis=0)]))
    return np.median(np.stack(calls), axis=0)


def main():
    if len(sys.argv) > 1:
        raise SystemExit(f"decode_attention_probe: takes no arguments, got {sys.argv[1:]}")
    card = cs.environment()
    libs = build_variants()
    flush = torch.empty(cs.L2_CYCLE_BYTES // 4, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, q8, args in cases(g):
        plain = da.ragged_decode_attention_q8_plain if q8 else da.ragged_decode_attention_plain
        want = plain(*args[0])
        for name, lib in libs.items():
            call = caller(entries(lib)[1 if q8 else 0], q8)
            err = (call(*args[0]) - want).abs().max().item()
            if name == "timeline":
                med, last = timeline(lib, call, args, flush)
                print(f"timeline {label} (ns from the first block's start; median block / "
                      f"latest block): " + "; ".join(
                          f"{m}: {a:.0f} / {z:.0f}" for (m, _), a, z in zip(MARKS, med, last)))
                continue
            us = cs.cuda_ms(cs.cycled(call, args), iters=2 * len(args)) * 1e3
            print(f"probe {label}: {name}: us={us:.3f} max_abs_err={err:.3g}")
        del args
    print(card)


if __name__ == "__main__":
    main()

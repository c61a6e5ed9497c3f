#!/usr/bin/env python3
"""Where the device time of a K5/K7 call goes (the PyTorch port's decode
GEMV, indextts_tpu_torch/csrc/gemv.cu `gemv_kernel`), on one NVIDIA GPU:

  PYTHONPATH=. python3 tools/gemv_probe.py

1. Plans: each full-width GPT shape under other launch plans than
   ops/gemv.py `gemv_plan` picks (column tiles of 64, 128 and 256; the
   block's rows as one TMA box or as 5-8), through the C entry points,
   each checked against the plain version.
2. Parts: the kernel rebuilt with parts cut out (its results are then
   wrong; for timing only): the cross-block sum, the TMA copies, the
   decode-row loads, the epilogue loads, the contraction; all of those
   (the skeleton); the skeleton without its copy barriers; and a kernel
   of the same launch that returns at once.

Times are chip_smoke.py's: CUDA events over replays of a CUDA graph of
calls that cycle through more than 100 MB of weights.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from indextts_tpu_torch.ops import cuda_lib, gemv

SHAPES = [("W8 c_attn", False, 1280, 3840), ("W8 attn c_proj", False, 1280, 1280),
          ("W8 head", False, 1280, 8320), ("W4 c_attn", True, 1280, 3840),
          ("W4 attn c_proj", True, 1280, 1280), ("W8 one cluster", False, 128, 128)]

WAIT = "        mbar_wait(&bars[c], pass & 1);\n"
CUTS = {
    "cross-block sum": [
        ('    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");\n', ""),
        ("int* dst = cluster.map_shared_rank(recv, owner) +", "int* dst = recv +"),
        ("  cluster.sync();\n\n  // 6.", "  __syncthreads();\n\n  // 6."),
        ('  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");\n', "")],
    "TMA copies": [
        ("tma_load_2d(smem + tid * rb * tile, &w_map, col0, d0 + (b0 + tid) * rb, &bars[tid]);",
         ""),
        ("mbar_expect_tx(&bars[tid], rb * tile);", "mbar_expect_tx(&bars[tid], 0);")],
    "decode-row loads": [("word |= (xr[i * q4 + h * R] & 0xFF) << (8 * i);",
                          "word |= ((e + i) & 0xFF) << (8 * i);")],
    "epilogue loads": [("      ep_a[k] = a[i / cpr];\n      ep_s[k] = s[f];\n      ep_b[k] = bias[f];",
                        "      ep_a[k] = 1.f;\n      ep_s[k] = 1.f;\n      ep_b[k] = 0.f;")],
    "contraction": [(WAIT, WAIT + "        continue;\n")],
}
SKELETON = [p for cut in CUTS.values() for p in cut]
NO_BARRIERS = [(WAIT + "        continue;\n", "        continue;\n"),
               ("        if (pass == 0) {\n          mbar_init(&bars[tid], 1);\n"
                '          asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");\n'
                "        }\n        mbar_expect_tx(&bars[tid], 0);\n", "")]
VARIANTS = {"whole kernel": [], **{f"without {k}": v for k, v in CUTS.items()},
            "skeleton (all five cut)": SKELETON,
            "skeleton without copy barriers": SKELETON + NO_BARRIERS,
            "returns at once": [("  cg::cluster_group cluster = cg::this_cluster();\n",
                                 "  if (nb > 0) return;\n"
                                 "  cg::cluster_group cluster = cg::this_cluster();\n")]}


def edited(src: str, pairs) -> str:
    """The K5/K7 section of gemv.cu with each (old, new) replaced; raises
    if a pattern is missing (the kernel changed under the probe)."""
    a, b = src.index("// K5 / K7: one launch"), src.index("// K6 / K8: one launch")
    k5 = src[a:b]
    for old, new in pairs:
        if old not in k5:
            raise SystemExit(f"gemv_probe: pattern not in csrc/gemv.cu: {old[:70]!r}")
        k5 = k5.replace(old, new)
    return src[:a] + k5 + src[b:]


def build_variants():
    """One nvcc per variant, all started together; their gemv_w8/gemv_w4."""
    src = (cuda_lib.CSRC / "gemv.cu").read_text()
    out = cuda_lib.build_dir() / "gemv_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, pairs) in enumerate(VARIANTS.items()):
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(edited(src, pairs))
        procs[name] = (so, subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"gemv_probe: {name} did not build:\n{log[-3000:]}")
        fns[name] = entries(ctypes.CDLL(str(so)))
    return fns


def entries(lib):
    fns = {}
    for symbol in ("gemv_w8", "gemv_w4"):
        fn = getattr(lib, symbol)
        fn.argtypes = [cuda_lib.P] * 6 + [cuda_lib.I] * 6 + [cuda_lib.P]
        fn.restype = cuda_lib.I
        fns[symbol] = fn
    return fns


def planned(fn, plan, d):
    """A call of C entry `fn` under `plan` (tile, box_rows, pass_boxes)."""
    def call(xq, a, w, s, bias):
        y = torch.empty((xq.shape[0], w.shape[1]), device="cuda")
        cuda_lib.check(fn(xq.data_ptr(), a.data_ptr(), w.data_ptr(), s.data_ptr(),
                          bias.data_ptr(), y.data_ptr(), xq.shape[0], d, w.shape[1], *plan,
                          torch.cuda.current_stream().cuda_stream), "gemv_probe")
        return y
    return call


def main():
    if len(sys.argv) > 1:
        raise SystemExit(f"gemv_probe: takes no arguments, got {sys.argv[1:]}")
    card = cs.environment()
    variants = build_variants()
    current = entries(cuda_lib.load("gemv"))
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, w4, d, f in SHAPES:
        rows = d // 2 if w4 else d
        copies = cs.cycle_copies(rows * f, 24)
        xq, a = cs.q8_row(g, 1, d)
        a = a.reshape(-1).contiguous()
        weight = cs.q4_weight if w4 else cs.q8_weight
        args = [(xq, a, *weight(g, d, f)) for _ in range(copies)]
        symbol = "gemv_w4" if w4 else "gemv_w8"
        want = (gemv.gemv_w4_plain if w4 else gemv.gemv_w8_plain)(*args[0])
        chosen = gemv.gemv_plan(rows, f, torch.cuda.get_device_properties(0).multi_processor_count)
        block_rows = rows // gemv.CLUSTER
        many = next(r for r in range(block_rows // 8, block_rows + 1) if r % 4 == 0
                    and block_rows % r == 0)
        plans = sorted({chosen, *((t, block_rows, 1) for t in gemv.GEMV_TILES if t <= 2 * f),
                        (chosen[0], many, block_rows // many)})
        for plan in plans if d > 128 else [chosen]:
            call = planned(current[symbol], plan, d)
            got = call(*args[0])
            ok = (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()
            us = cs.cuda_ms(cs.cycled(call, args), iters=2 * copies) * 1e3
            print(f"plan {label} D={d} F={f}: tile={plan[0]} box_rows={plan[1]} "
                  f"boxes={block_rows // plan[1]} blocks={-(-f // plan[0]) * gemv.CLUSTER}"
                  f"{' (gemv_plan)' if plan == chosen else ''}: us={us:.3f} ok={ok}")
        for name, fns in variants.items():
            us = cs.cuda_ms(cs.cycled(planned(fns[symbol], chosen, d), args), iters=2 * copies)
            print(f"parts {label} D={d} F={f}: {name}: us={us * 1e3:.3f}")
    print(card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device times of K2, the PyTorch port's anti-aliased SnakeBeta kernel
(indextts_tpu_torch/csrc/snake.cu), and of K2-bf16, its bfloat16 kernel,
for the port of any tree, on one NVIDIA GPU:

  python3 tools/snake_times.py [TREE]
  python3 tools/snake_times.py --probe

TREE (default: this repository) holds the `indextts_tpu_torch` that is
timed, for example a parent commit unpacked with `git archive` into
build/. The timing code is always this repository's chip_smoke.py
(`time_k2`, `time_k2_bf16`: CUDA events over graph replays of one vocoder
call's 37 launches, each on its own input), so two trees run in turns on
one card (parent, change, change, parent) are timed alike: K2 at the main
path's shapes and at the longest segment's; K2-bf16 over 8 rows (a
batched request's call) and over one row of the main path's shapes, each
in turns with the float32 K2 on the same values, and over 8 rows of the
longest segment's. Then K2's errors at the main path's first shape,
against the plain version and against it in float64, also with beta =
exp(-4) on every fourth channel; K2-bf16's at each main-path shape
against the plain version rounded once, with the share of outputs one
bfloat16 step apart; and a checksum of K2's float32 output on
fixed inputs (`k2_checksum`), equal on two trees whose float32 kernel
computes the same bits. Prints the card's name and power limit first.

--probe times this repository's kernel rebuilt from an edited copy of
its source (csrc/snake.cu stays as it is) with another sine, each still
right: `sinf`, and the SFU's `__sinf` after a reduction by 2 pi; and with
parts cut out, whose results are then wrong: each sine replaced by its
argument, and loads and stores only (the output is the input); and
x.clone() of each launch's input, the same bytes moved by one PyTorch
call. The right builds also print those errors. Each build gives its
registers (ptxas) and SASS instruction counts (cuobjdump -sass); with
every chunk on the interior path (counted, never run: it reads and writes
past the rows) a kernel is one chunk's straight line, so its count over R
is what a lane issues per output; the source is also built unedited for
its counts. K2-bf16 (`probe_bf16`) is timed over a vocoder call at 8 rows
and at one row as built and in edited copies: its cosine cut; its TMA
loads and stores cut (compute only), also with its up FIR or its snake
and split cut; every arithmetic part cut (memory only), also with each
box's rows adjacent in memory (a DRAM-locality probe); with L2 prefetches
of the boxes ahead; with rings of 3 and 6 boxes a warp at 5 and 3 blocks
an SM; and x.clone() of each launch's input. For K2-bf16's kernels the count is that of the loop over
output blocks (the backward branch whose body holds the most HMMA): 10
HMMA a step of 8 outputs x 16 rows, 4 outputs a lane, so its count over
4 x HMMA / 10 is what a lane issues per output outside an item's set-up.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

SIN_HEAD = "__device__ __forceinline__ float sin_pm(float v) {\n"
SINES = {
    "sinf": "  return sinf(v);\n",
    "SFU sine": ("  constexpr float kShift = 12582912.f;\n"
                 "  const float j = fmaf(v, 0.15915494309189535f, kShift) - kShift;\n"
                 "  float r = fmaf(j, -6.28318548202514648f, v);\n"
                 "  r = fmaf(j, 1.74845553e-7f, r);\n"
                 "  return __sinf(r);\n"),
    "sines cut": "  return v;\n",
}
COPY_ONLY = ("    y[i] = acc;\n", "    y[i] = xv[3 + i];\n")
INTERIOR = ("  if (t0 >= 6 && t0 + 32 * kR + 6 <= T)\n", "  if (true)\n")
# name: (edits, timed); an edit is (old text, new text) or the name of a
# sine in SINES; the untimed builds are only counted
VARIANTS = {
    "as in the source": ([], False),
    "sinf": (["sinf"], True),
    "SFU sine": (["SFU sine"], True),
    "sines cut": (["sines cut"], True),
    "loads and stores only": ([COPY_ONLY], True),
    "interior path only": ([INTERIOR], False),
    **{f"interior path only, {k}": ([INTERIOR, k], False) for k in SINES},
}
# K2-bf16's kernels with parts cut out or changed (results wrong unless
# said), timed beside it at a vocoder call's 8 rows and one row; the first
# only counted: every output box on the straight-line group, so the
# innermost loop is one group of 8 steps
BF16_GROUPS = ("      if (kTma && j % 8 == 0 && j + 8 <= nsteps && 8 * (k0 + j + 8) + 8 < T) {\n",
               "      if (kTma) {\n")
BF16_UP_CUT = ("  mma16(ce, win, kSwap ? bs[kEvenLo] : bf[kEvenLo]);\n"
               "  mma16(co, win, kSwap ? bs[kOddLo] : bf[kOddLo]);\n"
               "  mma16(ce, win, kSwap ? bs[kEvenHi] : bf[kEvenHi]);\n"
               "  mma16(co, win, kSwap ? bs[kOddHi] : bf[kOddHi]);\n",
               "  ce[0] = __uint_as_float(win[0]); ce[1] = __uint_as_float(win[1]);\n"
               "  co[2] = __uint_as_float(win[2]);\n"
               "  co[3] = __uint_as_float(win[3] ^ bf[kEvenLo][0] ^ bs[kOddHi][1]);\n")
BF16_DOWN_CUT = ("  mma16(acc, pl, dh);\n  mma16(acc, ph, dl);\n  mma16(acc, ph, dh);\n",
                 "  acc[0] += __uint_as_float(ph[0]); acc[1] += __uint_as_float(pl[1]);\n"
                 "  acc[2] += __uint_as_float(ph[2] ^ dh[0]); acc[3] += __uint_as_float(pl[3]);\n")
BF16_COS_CUT = ("  return fmaf(-h, __cosf(a2 * u), u + h);\n", "  return fmaf(-h, a2 * u, u + h);\n")
BF16_SNAKE_CUT = ("      snake_split<decltype(edge)::value>(ce, co, a2, h, q, T, lane, uT, ph, pl);\n",
                  "      ph[0] = __float_as_uint(ce[0]); ph[1] = __float_as_uint(co[1]);\n"
                  "      ph[2] = __float_as_uint(ce[2]); ph[3] = __float_as_uint(co[3]);\n"
                  "      pl[0] = ph[1]; pl[1] = ph[2]; pl[2] = ph[3]; pl[3] = ph[0];\n")
BF16_STORES_CUT = ("            tma_store_2d(&omap, ws + (kStages + (n_out & 1)) * kBoxBytes, "
                   "s0 + 8 * (j - s), r0);\n", "            ;\n")
BF16_LOADS_CUT = ("      mbar_expect_tx(&bar[st], kBoxBytes);\n"
                  "      tma_load_2d(ws + st * kBoxBytes, &xmap, p_s0 + kBox * p_box, p_r0, "
                  "&bar[st]);\n", "      mbar_arrive(&bar[st], true);\n")
BF16_NO_MEM = [BF16_LOADS_CUT, BF16_STORES_CUT]
BF16_MEM_ONLY = [BF16_UP_CUT, BF16_DOWN_CUT, BF16_SNAKE_CUT]
# L2 prefetches of the boxes 4-7 past the one a group starts, every 4th
# group (results right)
BF16_PREFETCH = ("        const bool ring = i + 1 < nbox;\n",
                 "        const bool ring = i + 1 < nbox;\n"
                 "        if (i % 4 == 0 && lane == 0)\n"
                 "          for (int b = i + 4; b < min(i + 8, nbox); ++b)\n"
                 "            asm volatile(\"cp.async.bulk.prefetch.tensor.2d.L2.global.tile "
                 "[%0, {%1, %2}];\" :: \"l\"(reinterpret_cast<uint64_t>(&xmap)), "
                 "\"r\"(s0 + kBox * b), \"r\"(r0) : \"memory\");\n")
# every box a contiguous 2 KB of memory (T % 64 == 0): the same bytes moved
# with the rows of a box adjacent
BF16_CONTIGUOUS = [
    ("  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)R};\n"
     "  const cuuint64_t strides[1] = {(cuuint64_t)T * 2};\n",
     "  const cuuint64_t dims[2] = {64, (cuuint64_t)R * T / 64};\n"
     "  const cuuint64_t strides[1] = {128};\n"),
    ("      tma_load_2d(ws + st * kBoxBytes, &xmap, p_s0 + kBox * p_box, p_r0, &bar[st]);\n",
     "      tma_load_2d(ws + st * kBoxBytes, &xmap, 0, (p_r0 * (T / 64) + p_s0 / 4 + 16 * p_box)"
     " % (R * T / 64 - 16), &bar[st]);\n"),
    ("            tma_store_2d(&omap, ws + (kStages + (n_out & 1)) * kBoxBytes, "
     "s0 + 8 * (j - s), r0);\n",
     "            tma_store_2d(&omap, ws + (kStages + (n_out & 1)) * kBoxBytes, 0, "
     "(r0 * (T / 64) + s0 / 4 + 2 * (j - s)) % (R * T / 64 - 16));\n")]
# other rings a warp and blocks an SM (results right)
BF16_RING = ("constexpr int kBMinBlocks = 4;  // blocks an SM: ops/snake.py SNAKE_BF16_BLOCKS\n"
             "constexpr int kStages = 4;      // x boxes a warp has in flight\n")


def ring(stages: int, blocks: int):
    return (BF16_RING, BF16_RING.replace("kBMinBlocks = 4", f"kBMinBlocks = {blocks}")
            .replace("kStages = 4", f"kStages = {stages}"))


BF16_VARIANTS = {
    "bf16 groups only": [BF16_GROUPS],
    "bf16 cosine cut": [BF16_COS_CUT],
    "bf16 TMA loads and stores cut": BF16_NO_MEM,
    "bf16 compute only, up FIR cut": BF16_NO_MEM + [BF16_UP_CUT],
    "bf16 compute only, snake and split cut": BF16_NO_MEM + [BF16_SNAKE_CUT],
    "bf16 memory only": BF16_MEM_ONLY,
    "bf16 memory only, boxes contiguous": BF16_MEM_ONLY + BF16_CONTIGUOUS,
    "bf16 L2 prefetch": [BF16_PREFETCH],
    "bf16 ring of 3, 5 blocks an SM": [ring(3, 5)],
    "bf16 ring of 6, 3 blocks an SM": [ring(6, 3)],
}
# the blocks an SM that a variant's launches plan for
BF16_BLOCKS = {"bf16 ring of 3, 5 blocks an SM": 5, "bf16 ring of 6, 3 blocks an SM": 3}
SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)$")
LABEL = re.compile(r"^(\.L_x_\d+):")
TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sass_counts(so: Path):
    """Per kernel of the library: (instructions up to its last unpredicated
    EXIT, the opcodes among them). Out-of-line cold paths (sinf's slow
    path) follow that EXIT and are not counted."""
    out = {}
    for name, lines in sass_functions(so).items():
        ops = [(m.group(2), m.group(3)) for m in map(SASS_LINE.match, lines) if m]
        last = max((i for i, (p, op) in enumerate(ops) if op == "EXIT" and not p), default=len(ops) - 1)
        kept = [op.split(".")[0] for _, op in ops[:last + 1]]
        out[name] = (len(kept), collections.Counter(kept))
    return out


def sass_functions(so: Path):
    """Each kernel's SASS lines, by name."""
    from indextts_tpu_torch.ops import cuda_lib

    cuobjdump = Path(cuda_lib.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return {block.split("\n", 1)[0].strip(): block.splitlines()[1:]
            for block in text.split("Function : ")[1:]}


def hottest_loop(lines):
    """(instructions, the opcodes among them) of the body of the innermost
    backward branch whose body holds at least 40 HMMA (4 steps): from its
    target to the branch."""
    ops, labels = [], {}
    for line in lines:
        m = LABEL.match(line.strip())
        if m:
            labels[m.group(1)] = len(ops)
            continue
        m = SASS_LINE.match(line)
        if m:
            ops.append((int(m.group(1), 16), m.group(3), m.group(4)))
    at = {addr: i for i, (addr, _, _) in enumerate(ops)}
    best = (len(ops) + 1, collections.Counter())
    for i, (_, op, rest) in enumerate(ops):
        m = TARGET.search(rest) if op.startswith("BRA") else None
        t = None if m is None else (labels.get(m.group(1)) if m.group(1)
                                    else at.get(int(m.group(2), 16)))
        if t is None or t > i:
            continue
        body = collections.Counter(op.split(".")[0] for _, op, _ in ops[t:i + 1])
        if body["HMMA"] >= 40 and i + 1 - t < best[0]:
            best = (i + 1 - t, body)
    return (best[0], best[1]) if best[1] else (0, best[1])


def print_bf16_loops(label: str, so: Path):
    for name, lines in sass_functions(so).items():
        if "snake_bf16_kernel" not in name:
            continue
        n, ops = hottest_loop(lines)
        if not ops["HMMA"]:
            print(f"sass {label}: {name}: no loop with HMMA found")
            continue
        outputs = 4 * ops["HMMA"] / 10
        top = ", ".join(f"{op} {k}" for op, k in ops.most_common(12))
        print(f"sass {label}: {name}: its output-block loop {n} instructions, {ops['HMMA']} "
              f"HMMA, {ops['MUFU']} MUFU ({n / outputs:.1f} a lane per output over "
              f"{outputs:g} outputs a lane); {top}")


def print_sass(label: str, so: Path, r: int):
    for name, (n, ops) in sass_counts(so).items():
        if "snake_kernel" not in name:
            continue
        top = ", ".join(f"{op} {k}" for op, k in ops.most_common(10))
        print(f"sass {label}: {name}: {n} instructions to the last EXIT ({n / r:.1f} a "
              f"lane per output at R={r}); {top}")


def edited(src: str, edits) -> str:
    for e in edits:
        if isinstance(e, str):
            start = src.index(SIN_HEAD) + len(SIN_HEAD)
            src = src[:start] + SINES[e] + src[src.index("}\n", start):]
            continue
        old, new = e
        if old not in src:
            raise SystemExit(f"snake_times: pattern not in the source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(variants):
    """One nvcc per variant (name: edits), all started together; their
    libraries."""
    from indextts_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC / "snake.cu").read_text()
    out = cuda_lib.build_dir() / "snake_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(variants.items()):
        cu, so = out / f"v{i}.cu", out / f"libv{i}.so"
        cu.write_text(edited(src, edits))
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-Xptxas=-v", "-I",
               str(cuda_lib.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"snake_times: {name} did not build:\n{log[-3000:]}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
        libs[name] = so
    return libs


def caller(so: Path):
    """A call of the library's K2 entry as the wrapper makes it."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.ops import snake as k2

    fn = ctypes.CDLL(str(so)).anti_alias_snake
    fn.argtypes = [cuda_lib.P] * 5 + [cuda_lib.I] * 8 + [cuda_lib.P]
    fn.restype = cuda_lib.I
    taps = ctypes.addressof(k2._taps_arg())

    def call(x, a, b, logscale=True):
        B, C, T = x.shape
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), taps, out.data_ptr(), B, C, T,
                 int(logscale), *k2.snake_plan(B, C, T), int(T % 4 == 0),
                 torch.cuda.current_stream().cuda_stream)
        cuda_lib.check(err, "snake_times")
        return out
    return call


def error_cases(cs, shape, g):
    """Inputs at (C, T) = shape drawn as chip_smoke.py draws them, and with
    beta = exp(-4) on every fourth channel: per label (inputs, the plain
    version's output, its output in float64). Prints the plain version's
    own error against float64."""
    from indextts_tpu_torch.ops import snake as k2

    cases = {}
    for label, small in (("", False), (", small beta", True)):
        label = f"C={shape[0]} T={shape[1]}{label}"
        x = cs.k2_inputs(g, 1, *shape, small_beta=small)
        want = k2.anti_alias_snake_plain(*x, True)
        exact = k2.anti_alias_snake_plain(*(t.double() for t in x), True)
        print(f"plain version at {label}: max|out| {want.abs().max().item():.3g}, "
              f"max_abs_err against float64 {(want - exact).abs().max().item():.3g}")
        cases[label] = (x, want, exact)
    return cases


def errors(call, cases):
    out = []
    for label, (x, want, exact) in cases.items():
        got = call(*x)
        out.append(f"max_abs_err at {label} {(got - want).abs().max().item():.3g} "
                   f"(against float64 {(got - exact).abs().max().item():.3g})")
    return out


def caller_bf16(so: Path, blocks=None):
    """A call of the library's K2-bf16 entry as the wrapper makes it, its
    grid planned for `blocks` an SM (default the kernel's own)."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.ops import snake as k2

    fn = ctypes.CDLL(str(so)).anti_alias_snake_bf16
    fn.argtypes = [cuda_lib.P] * 5 + [cuda_lib.I] * 9 + [cuda_lib.P]
    fn.restype = cuda_lib.I
    band = ctypes.addressof(k2._band_arg())

    def call(x, a, b, logscale=True):
        B, C, T = x.shape
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), band, out.data_ptr(), B, C, T,
                 int(logscale), *k2.snake_bf16_plan(B, C, T, cuda_lib.sm_count(0), blocks),
                 int(a.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        cuda_lib.check(err, "snake_times")
        return out
    return call


def probe_bf16(cs, seq, g, whole, libs):
    """K2-bf16 as built and with parts cut out, and x.clone() a launch (the
    same bytes moved by one PyTorch call), at 8 rows and one row of a
    vocoder call at the main path."""
    runs = [("K2-bf16 as in the source", caller_bf16(whole))]
    runs += [(name, caller_bf16(libs[name], BF16_BLOCKS.get(name))) for name in BF16_VARIANTS
             if name != "bf16 groups only"]
    runs.append(("x.clone() a launch", lambda x, *_: x.clone()))
    for name, call in runs:
        times = []
        for rows in (cs.CONT_REQUESTS, 1):
            ms, _, turns, _, b_ms, _, _ = cs.time_k2_bf16(seq, g, rows, False, call=call)
            times.append(f"{rows} rows {ms:.4f} ms ({turns[0]:.4f}, {turns[1]:.4f}; "
                         f"bound {b_ms:.4f})")
        print(f"probe {name}: " + "; ".join(times))


def probe(cs, seqs, g):
    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.ops import snake as k2

    r = k2.SNAKE_LANE_OUTPUTS
    whole = cuda_lib.build(["snake"])["snake"]
    print_bf16_loops("as in the source", whole)
    libs = build_variants({**{k: e for k, (e, _) in VARIANTS.items()}, **BF16_VARIANTS})
    for name, so in libs.items():
        if name in BF16_VARIANTS:
            print_bf16_loops(name, so)
        else:
            print_sass(name, so, r)
    probe_bf16(cs, seqs["main"], g, whole, libs)
    runs = [("whole kernel", whole, True)]
    runs += [(name, libs[name], name in SINES and name != "sines cut")
             for name, (_, timed) in VARIANTS.items() if timed]
    cases = error_cases(cs, seqs["main"][0], g)
    for name, so, right in runs:
        call = caller(so)
        times = []
        for label, seq in seqs.items():
            ms, _, b_ms, _ = cs.time_k2(seq, g, plain=False, call=call)
            times.append(f"{label} {ms:.4f} ms (bound {b_ms:.4f})")
        print(f"probe {name}: " + "; ".join(times + (errors(call, cases) if right else [])))
    # the same bytes moved by one PyTorch call a launch: a read and a write
    times = [f"{label} {cs.time_k2(seq, g, plain=False, call=lambda x, *_: x.clone())[0]:.4f} ms"
             for label, seq in seqs.items()]
    print("probe x.clone() a launch: " + "; ".join(times))


def main():
    args = sys.argv[1:]
    if len(args) > 1:
        raise SystemExit(f"snake_times: takes one tree or --probe, got {args}")
    tree = HERE if not args or args[0] == "--probe" else Path(args[0]).resolve()
    if not (tree / "indextts_tpu_torch").is_dir():
        raise SystemExit(f"snake_times: no indextts_tpu_torch in {tree}")
    sys.path.insert(0, str(tree))
    cs = load_chip_smoke()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("snake_times: needs a CUDA device")
    print(card_line())
    import indextts_tpu_torch
    from indextts_tpu_torch.config import load_config

    print(f"timing the port in {Path(indextts_tpu_torch.__file__).parent.parent}")
    cfg = load_config()
    seqs = {"main": cs.main_path_shapes(cfg, cs.MAX_MEL_TOKENS)["snake"],
            "longest": cs.main_path_shapes(cfg, cfg.runtime.max_mel_tokens)["snake"]}
    g = torch.Generator(device="cuda").manual_seed(2)
    if args and args[0] == "--probe":
        probe(cs, seqs, g)
        return
    for label, seq in seqs.items():
        ms, _, b_ms, by = cs.time_k2(seq, g, plain=False)
        print(f"K2 {label} ({len(seq)} launches, one vocoder call): kernel_ms={ms:.4f} "
              f"bound_ms={b_ms:.4f} ({by})")
    for label, rows, with32 in (("main", cs.CONT_REQUESTS, True), ("main", 1, True),
                                ("longest", cs.CONT_REQUESTS, False)):
        ms, ms32, turns, _, b_ms, by, b32 = cs.time_k2_bf16(seqs[label], g, rows, with32)
        print(f"K2-bf16 {label}, {rows} rows ({len(seqs[label])} launches, one vocoder call): "
              f"kernel_ms={ms:.4f} bound_ms={b_ms:.4f} ({by}); turns "
              + ("float32, bf16, bf16, float32: " if with32 else "")
              + ", ".join(f"{t:.4f}" for t in turns)
              + (f"; float32 kernel_ms={ms32:.4f} bound_ms={b32:.4f}" if with32 else ""))
    from indextts_tpu_torch.ops import snake as k2

    print("K2 " + "; ".join(errors(k2.anti_alias_snake, error_cases(cs, seqs["main"][0], g))))
    for C, T in dict.fromkeys(seqs["main"]):
        x, a, b = (t.bfloat16() for t in cs.k2_inputs(g, 1, C, T))
        d = (k2.anti_alias_snake(x, a, b, True).float() - k2.anti_alias_snake_plain(
            x.float(), a.float(), b.float(), True).bfloat16().float()).abs()
        print(f"K2-bf16 main C={C} T={T}: max_abs_err {d.max().item():.3g}, "
              f"{(d > 0).float().mean().item():.2e} of the outputs one bf16 step apart")
    print(f"K2 float32 output checksum on fixed inputs: {cs.k2_checksum()}")
    if hasattr(k2, "bf16_attributes"):
        print(f"K2-bf16 (registers, local bytes a thread): {k2.bf16_attributes()}")


if __name__ == "__main__":
    main()

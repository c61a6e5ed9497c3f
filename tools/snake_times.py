#!/usr/bin/env python3
"""Device times of K2, the PyTorch port's anti-aliased SnakeBeta kernel
(indextts_tpu_torch/csrc/snake.cu), for the port of any tree, on one
NVIDIA GPU:

  python3 tools/snake_times.py [TREE]
  python3 tools/snake_times.py --probe

TREE (default: this repository) holds the `indextts_tpu_torch` that is
timed, for example a parent commit unpacked with `git archive` into
build/. The timing code is always this repository's chip_smoke.py
(`time_k2`: CUDA events over graph replays of one vocoder call's 37
launches, each on its own input), at the main path's shapes and at the
longest segment's, so two trees run in turns on one card are timed alike;
then its errors at the main path's first shape, against the plain version
and against it in float64, also with beta = exp(-4) on every fourth
channel. Prints the card's name and power limit first.

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
its counts.
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
SASS_LINE = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


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
    from indextts_tpu_torch.ops import cuda_lib

    cuobjdump = Path(cuda_lib.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        ops = [(m.group(1), m.group(2)) for m in map(SASS_LINE.match, block.splitlines()) if m]
        last = max((i for i, (p, op) in enumerate(ops) if op == "EXIT" and not p), default=len(ops) - 1)
        kept = [op.split(".")[0] for _, op in ops[:last + 1]]
        out[name] = (len(kept), collections.Counter(kept))
    return out


def print_sass(label: str, so: Path, r: int):
    for name, (n, ops) in sass_counts(so).items():
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


def build_variants():
    """One nvcc per variant, all started together; their libraries."""
    from indextts_tpu_torch.ops import cuda_lib

    src = (cuda_lib.CSRC / "snake.cu").read_text()
    out = cuda_lib.build_dir() / "snake_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
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


def probe(cs, seqs, g):
    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.ops import snake as k2

    r = k2.SNAKE_LANE_OUTPUTS
    whole = cuda_lib.build(["snake"])["snake"]
    libs = build_variants()
    for name, so in libs.items():
        print_sass(name, so, r)
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
    from indextts_tpu_torch.ops import snake as k2

    print("K2 " + "; ".join(errors(k2.anti_alias_snake, error_cases(cs, seqs["main"][0], g))))


if __name__ == "__main__":
    main()

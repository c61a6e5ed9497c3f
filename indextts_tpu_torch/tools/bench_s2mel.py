#!/usr/bin/env python
"""A/B the s2mel CFM solve (fp32 vs bf16 DiT) at serving shapes on the port.

  python -m indextts_tpu_torch.tools.bench_s2mel [--steps 20] [--iters 5] \
      [--shapes 1x256,1x512,8x512] [--device cpu]

Counterpart of tools/bench_s2mel.py, with its flags (plus --device), its
inputs (drawn in its order from np.random.default_rng(0); the prompt a
quarter of the frames) and its keys `{B}x{T}_{fp32|bf16}_ms`. Each shape is
timed through the engine's captured solve (runtime/s2mel_infer.py
`S2MelRunner`: all Euler steps one CUDA graph on the card), so fp32 runs
K3 and bf16 K3-bf16; the first solve of a shape captures, then --iters
solves are timed on the host clock up to a read of the result. The DiT has
seeded random weights (seed 0) at the default config's widths, the bf16
model the same weights rounded. Prints per-shape times and the bf16/fp32
speedup on stderr and one JSON line on stdout, which adds `device`
({name, power_limit_w}) and `launches` (each kernel's launches over a
shape's timed solves) and is JSON where the JAX tool printed a Python
dict. BENCH_TINY=1 runs the tiny config on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Tuple


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m indextts_tpu_torch.tools.bench_s2mel")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--shapes", default="1x256,1x512,8x512")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; BENCH_TINY=1: the CPU)")
    return ap


def parse_shapes(spec: str) -> List[Tuple[int, int, int]]:
    """"BxT,..." -> [(B, T, prompt frames T // 4), ...]."""
    out = []
    for shape in spec.split(","):
        B, T = (int(v) for v in shape.split("x"))
        out.append((B, T, T // 4))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    tiny = os.environ.get("BENCH_TINY", "0") == "1"

    import numpy as np
    import torch

    from indextts_tpu_torch.bench import tiny_config
    from indextts_tpu_torch.config import IndexTTS2Config
    from indextts_tpu_torch.ops import launch_snapshot, launches_since
    from indextts_tpu_torch.runtime.engine import MODELS, load_model
    from indextts_tpu_torch.runtime.s2mel_infer import S2MelRunner
    from indextts_tpu_torch.utils.device import card_info, resolve_device

    dev = resolve_device(args.device or ("cpu" if tiny else None))
    cfg = tiny_config() if tiny else IndexTTS2Config()
    mel = cfg.s2mel.dit.in_channels
    content = cfg.s2mel.dit.content_dim
    style_dim = cfg.s2mel.dit.style_dim
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(0)
        with torch.device(dev):
            sd = dict(MODELS["s2mel"](cfg, dev).state_dict())
    runners = {name: S2MelRunner(load_model("s2mel", cfg, sd, dev, dt), args.steps, 0.7)
               for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    del sd
    device = card_info(dev)
    print(f"device: {device}", file=sys.stderr)

    rng = np.random.default_rng(0)
    results, launches = {}, {}
    for B, T, P in parse_shapes(args.shapes):
        shape = f"{B}x{T}"
        mu = torch.as_tensor(rng.standard_normal((B, T, content)), dtype=torch.float32,
                             device=dev)
        x_lens = torch.full((B,), T, dtype=torch.long, device=dev)
        prompt_x = np.zeros((B, mel, T), np.float32)
        prompt_x[:, :, :P] = rng.standard_normal((B, mel, P))
        prompt_x = torch.as_tensor(prompt_x, device=dev)
        style = torch.as_tensor(rng.standard_normal((B, style_dim)), dtype=torch.float32,
                                device=dev)
        noise = torch.as_tensor(rng.standard_normal((B, mel, T)), dtype=torch.float32,
                                device=dev)
        a = (mu, x_lens, prompt_x, P, style, noise)
        for name, runner in runners.items():
            float(runner.solve(*a).sum())  # capture + sync
            before = launch_snapshot()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = runner.solve(*a)
            float(out.sum())
            ms = (time.perf_counter() - t0) / args.iters * 1e3
            results[f"{shape}_{name}_ms"] = round(ms, 2)
            launches[f"{shape}_{name}"] = launches_since(before)
            print(f"B={B} T={T} {name}: {ms:8.2f} ms / solve", file=sys.stderr)
        f, b = results[f"{shape}_fp32_ms"], results[f"{shape}_bf16_ms"]
        print(f"B={B} T={T} bf16 speedup: {f / b:.2f}x", file=sys.stderr)

    out = dict(sorted(results.items()), device=device, launches=launches)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

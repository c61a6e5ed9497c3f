#!/usr/bin/env python
"""W4A8 vs W8A8 B=1 decode on the port (full-size GPT, seeded random weights,
one card).

  python -m indextts_tpu_torch.tools.bench_w4 [--device cpu]
  BENCH_W4_STEPS=200 BENCH_W4_XLA=1 python -m indextts_tpu_torch.tools.bench_w4

Counterpart of tools/bench_w4.py, with its environment (BENCH_W4_STEPS,
default 400 codes; BENCH_W4_XLA=1 adds W4 over the plain contraction) and
its runs: W8 + int8 KV with `gemv_impl` "xla" (the plain contraction, the
JAX tool's "current default"; the port's default "auto" takes K5 and K6 on
the card, which bench_decode_kernels.py measures), then W4 + int8 KV with
"pallas", where the port's `gemv_route` takes K7 and K8. A B=1 decode step reads every weight
once, so halving the weight bytes should show as a faster step when the
unpacking is hidden behind the loads. The inputs, the timing (the best of
3 decodes after one that captures) and the weights are those of
bench_decode_kernels.py. Prints one line a run and the W4/W8 speedup on
stderr and one JSON line on stdout: the steps, the runs (each with its
kernels' launches in one decode), `w4_over_w8` and `device` ({name,
power_limit_w}). BENCH_TINY=1 runs the tiny config on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def steps_from_env(env=os.environ) -> int:
    """BENCH_W4_STEPS: codes a decode (400)."""
    return int(env.get("BENCH_W4_STEPS", "400"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m indextts_tpu_torch.tools.bench_w4")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; BENCH_TINY=1: the CPU)")
    args = ap.parse_args(argv)
    steps = steps_from_env()

    from indextts_tpu_torch.runtime.engine import gemv_route
    from indextts_tpu_torch.tools.bench_decode_kernels import (
        bench_setup,
        decoder,
        float_gpt_state,
        quantized_gpt,
        time_decode,
    )
    from indextts_tpu_torch.utils.device import card_info

    cfg, dev = bench_setup(args.device)
    device = card_info(dev)
    print(f"device: {device}", file=sys.stderr)
    sd = float_gpt_state(cfg, dev)
    variants = [("w8+kv8 xla", 8, "xla"),
                ("W4+kv8 gemv=PALLAS (packed)", 4, "pallas")]
    if os.environ.get("BENCH_W4_XLA", "0") == "1":
        variants.append(("W4+kv8 gemv=xla (unpack/step)", 4, "xla"))
    runs = []
    for tag, wbits, impl in variants:
        model = quantized_gpt(cfg, sd, dev, wbits, impl)
        runs.append(time_decode(decoder(model, cfg, kv_int8=True), cfg, tag, 1, steps,
                                wbits=wbits, gemv_impl=impl,
                                gemv=gemv_route(impl, dev), cache="int8"))
        del model
    speedup = runs[1]["tok_s"] / runs[0]["tok_s"]
    print(f"w4/w8 speedup: {speedup:.2f}x", file=sys.stderr, flush=True)
    out = {"steps": steps, "runs": runs, "w4_over_w8": round(speedup, 3), "device": device}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

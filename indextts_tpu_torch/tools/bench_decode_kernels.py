#!/usr/bin/env python
"""Decode-kernel ablation on the port: the full-size W8A8 GPT (seeded random
weights) decoding on each of the port's own decode routes.

  python -m indextts_tpu_torch.tools.bench_decode_kernels [--steps 400] \
      [--batches 1,8,16] [--device cpu]

Counterpart of tools/bench_decode_kernels.py, which sweeps the JAX
package's dispatch knobs (TARS_Q8_VARIANT, TARS_GEMV_MAX_ROWS, block sizes,
phased reads); the port reads none of them. This tool measures what the
port dispatches on instead, at each batch size:

1. `gemv_impl` "auto", "pallas" and "xla" over the int8 KV cache (K4):
   whether the quantized GPT's decode calls take K5 and K6 (runtime/
   engine.py `gemv_route`; "auto" takes them on the card, so there it is
   "pallas", and is "xla" on the CPU);
2. the float cache (K1) against the int8 cache (K4), `gemv_impl` "auto".

Each run decodes --steps codes with the stop token banned (SamplingConfig
(ban_stop_token=True)) from the JAX tool's inputs: conds of zeros (B, 34,
D), 64 text ids drawn from np.random.default_rng(0) in [2, 12000). The
first decode captures its step; the best of 3 decodes, each timed on the
host clock up to a read of its codes, is reported, with each kernel's
launches in one decode. The weights are the JAX tool's: W8A8 blocks, the
float parameters in bfloat16. Prints one line a run on stderr and one JSON
line on stdout: the steps, the runs and `device` ({name,
power_limit_w}). BENCH_TINY=1 runs the tiny config on the CPU (its text
ids in [2, number_text_tokens), at most max_text_tokens of them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

CONDS = 34  # the GPT prompt's conditioning positions
ROUNDS = 3  # timed decodes a run; the best is reported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m indextts_tpu_torch.tools.bench_decode_kernels")
    ap.add_argument("--steps", type=int, default=400, help="codes a decode (the JAX tool's MN)")
    ap.add_argument("--batches", default="1,8,16", help="batch sizes, comma-separated")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; BENCH_TINY=1: the CPU)")
    return ap


def bench_setup(device_arg):
    """(config, device): the default config on `device_arg` (default the
    card), or under BENCH_TINY=1 the tiny config on the CPU."""
    from indextts_tpu_torch.bench import tiny_config
    from indextts_tpu_torch.config import IndexTTS2Config
    from indextts_tpu_torch.utils.device import resolve_device

    tiny = os.environ.get("BENCH_TINY", "0") == "1"
    dev = resolve_device(device_arg or ("cpu" if tiny else None))
    return (tiny_config() if tiny else IndexTTS2Config()), dev


def float_gpt_state(cfg, dev, seed: int = 0):
    """The GPT's float state dict, each module's own initialization drawn
    on `dev` from `seed` (as runtime/engine.py `random_params` draws it)."""
    import torch

    from indextts_tpu_torch.runtime.engine import MODELS

    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        with torch.device(dev):
            return dict(MODELS["gpt"](cfg, dev).state_dict())


def quantized_gpt(cfg, sd, dev, wbits: int, gemv_impl: str):
    """The UnifiedVoice of `sd` quantized to `wbits` (no int8 head), its
    float parameters in bfloat16, its single-row decode calls routed by
    `gemv_impl` as the engine routes them."""
    import torch

    from indextts_tpu_torch.runtime.engine import load_model
    from indextts_tpu_torch.weights import quantize_gpt_state_dict

    rt = dataclasses.replace(cfg.runtime, gpt_quantize=True, gpt_wbits=wbits,
                             gemv_impl=gemv_impl, head_quant=False)
    return load_model("gpt", dataclasses.replace(cfg, runtime=rt),
                      quantize_gpt_state_dict(sd, head=False, bits=wbits), dev, torch.bfloat16)


def decoder(model, cfg, kv_int8: bool):
    """A decoder over `model` with the stop token banned, its cache int8
    (K4) or float (K1), attn_impl "xla" as in the JAX tool."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    return GPTDecoder(model, cfg.gpt, SamplingConfig(ban_stop_token=True), kv_int8=kv_int8,
                      attn_impl="xla")


def text_shape(cfg):
    """(text ids a row, their exclusive upper bound): the JAX tool's 64 ids
    below 12000, within the config's text limits."""
    return min(64, cfg.gpt.max_text_tokens), min(12000, cfg.gpt.number_text_tokens)


def time_decode(dec, cfg, tag: str, B: int, steps: int, **info) -> dict:
    """Decode `steps` codes for B rows: one decode to capture, then the
    best of ROUNDS; the run's record, with each kernel's launches in the
    last decode."""
    import torch

    from indextts_tpu_torch.models.layers import dtype_of
    from indextts_tpu_torch.ops import launch_snapshot, launches_since

    n_text, high = text_shape(cfg)
    rng = np.random.default_rng(0)
    conds = torch.zeros((B, CONDS, cfg.gpt.model_dim), dtype=dtype_of(dec.model),
                        device=dec.device)
    text = rng.integers(2, high, (B, n_text))
    ids, pos, valid = dec.build_text_prompt_arrays(text, np.full(B, n_text), n_text)
    args = [conds] + [torch.as_tensor(a, device=dec.device) for a in (ids, pos, valid)] + [0]
    dec.generate(*args, max_new=steps).codes.cpu()
    best = float("inf")
    for _ in range(ROUNDS):
        before = launch_snapshot()
        t0 = time.perf_counter()
        dec.generate(*args, max_new=steps).codes.cpu()
        best = min(best, time.perf_counter() - t0)
        launches = launches_since(before)
    rec = {"tag": tag, "B": B, **info, "s": round(best, 4),
           "ms_per_step": round(best / steps * 1e3, 4), "tok_s": round(B * steps / best, 1),
           "launches": launches}
    print(f"{tag:36s} B={B:2d}: {best:.3f}s = {best / steps * 1e3:.3f} ms/step, "
          f"{B * steps / best:.0f} tok/s; launches {json.dumps(launches)}", file=sys.stderr,
          flush=True)
    return rec


def main(argv=None):
    args = build_parser().parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]

    from indextts_tpu_torch.runtime.engine import gemv_route
    from indextts_tpu_torch.utils.device import card_info

    cfg, dev = bench_setup(args.device)
    device = card_info(dev)
    print(f"device: {device}", file=sys.stderr)
    sd = float_gpt_state(cfg, dev)
    models = {impl: quantized_gpt(cfg, sd, dev, 8, impl) for impl in ("auto", "pallas", "xla")}
    del sd
    runs = []
    for B in batches:
        for impl, model in models.items():
            runs.append(time_decode(
                decoder(model, cfg, kv_int8=True), cfg, f"w8+kv8 gemv={impl}", B, args.steps,
                wbits=8, gemv_impl=impl, gemv=gemv_route(impl, dev), cache="int8"))
        runs.append(time_decode(
            decoder(models["auto"], cfg, kv_int8=False), cfg, "w8 float-cache gemv=auto", B,
            args.steps, wbits=8, gemv_impl="auto", gemv=gemv_route("auto", dev),
            cache="float"))
    out = {"steps": args.steps, "runs": runs, "device": device}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

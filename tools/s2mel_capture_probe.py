#!/usr/bin/env python3
"""The CFM solve captured two ways, on one NVIDIA GPU:

  PYTHONPATH=. python3 tools/s2mel_capture_probe.py

The default config's S2Mel with seeded random weights, at the main path's
solve shape (chip_smoke.main_path_shapes: the prompt's frames and the
target's 128-frame bucket, T=898 with 774 valid):

  (a) "solve": the port's runner (runtime/s2mel_infer.py `S2MelRunner`), one
      graph of all 20 Euler steps, one replay a solve;
  (b) "step": one Euler step captured over static buffers, its t computed
      on the device from a step counter the graph advances, replayed 20
      times a solve after an eager reset of the state and the counter.

Each is captured once (host seconds and the pool's bytes printed) and then
timed with CUDA events over ROUNDS solves a turn, in turns (a, b, b, a); the
mels must be equal to the bit. Prints the card's name and power limit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

ROUNDS = 5


def main():
    if len(sys.argv) > 1:
        raise SystemExit(f"s2mel_capture_probe: takes no arguments, got {sys.argv[1:]}")
    card = cs.environment()
    import torch

    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.models.s2mel import S2Mel
    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.runtime.engine import next_bucket
    from indextts_tpu_torch.runtime.s2mel_infer import S2MelRunner

    cfg = load_config()
    shapes = cs.main_path_shapes(cfg, cs.MAX_MEL_TOKENS)
    T, valid = shapes["dit_T"], shapes["dit_valid"]
    ref = T - next_bucket(int(cs.MAX_MEL_TOKENS * 1.72), 128, 128)  # the prompt's frames
    dev = torch.device("cuda")
    with torch.random.fork_rng(devices=[dev]):
        torch.manual_seed(0)
        with torch.device(dev):
            model = S2Mel(cfg.s2mel).eval().requires_grad_(False)
    rt = cfg.runtime
    runner = S2MelRunner(model, rt.diffusion_steps, rt.cfg_rate)
    g = torch.Generator(device=dev).manual_seed(1)
    C = cfg.s2mel.dit.in_channels
    mu = torch.randn((1, T, cfg.s2mel.dit.content_dim), generator=g, device=dev)
    mu[:, valid:] = 0
    prompt_x = torch.zeros((1, C, T), device=dev)
    prompt_x[:, :, :ref] = torch.randn((1, C, ref), generator=g, device=dev)
    style = torch.randn((1, cfg.s2mel.dit.style_dim), generator=g, device=dev)
    noise = torch.randn((1, C, T), generator=g, device=dev)
    x_lens = torch.tensor([valid], device=dev)
    args = (mu, x_lens, prompt_x, ref, style, noise)

    # (a) the runner's 20-step graph
    t0 = time.perf_counter()
    want = runner.solve(*args)
    torch.cuda.synchronize()
    print(f"solve graph: first call (one eager step, the capture, a replay) "
          f"{time.perf_counter() - t0:.3f} s; "
          f"pool {cuda_lib.pool_bytes(runner.pool) / 2**20:.1f} MiB")

    # (b) one step over static buffers, t from a device step counter
    n, rate = rt.diffusion_steps, rt.cfg_rate
    dt = np.float32(1.0 / n)
    stream, pool = torch.cuda.Stream(), torch.cuda.graph_pool_handle()
    in_prompt = (torch.arange(T, device=dev) < ref)[None, None, :]
    x = torch.zeros_like(noise)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    stacked = [torch.cat([a, torch.zeros_like(a)]) for a in (prompt_x, style, mu)]
    lens = torch.cat([x_lens, x_lens])

    def euler_step():
        t = (step.to(torch.float32) * float(dt)).expand(2)
        dphi = model.velocity(torch.cat([x, x]), stacked[0], lens, t, stacked[1],
                              stacked[2]).float()
        d_cond, d_null = dphi.chunk(2, dim=0)
        x_new = x + float(dt) * ((1.0 + rate) * d_cond - rate * d_null)
        x.copy_(torch.where(in_prompt, torch.zeros_like(x_new), x_new))
        step.add_(1)

    def reset():
        x.copy_(torch.where(in_prompt, torch.zeros_like(noise), noise))
        step.zero_()

    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            reset()
            euler_step()
            with cuda_lib.capture(graph, stream, pool):
                euler_step()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        print(f"step graph: one eager step and the capture {time.perf_counter() - t0:.3f} s; "
              f"pool {cuda_lib.pool_bytes(pool) / 2**20:.1f} MiB")

        def step_solve():
            reset()
            for _ in range(n):
                graph.replay()
            return x

        def solve_solve():
            prog = next(iter(runner.programs.values()))
            prog.graph.replay()
            return prog.out

        ways = {"solve": solve_solve, "step": step_solve}
        times = {k: [] for k in ways}
        for name in ("solve", "step", "step", "solve"):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(ROUNDS):
                out = ways[name]()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b) / ROUNDS)
            if not torch.equal(out, want):
                raise SystemExit(f"s2mel_capture_probe: the {name} graph's mel differs by up "
                                 f"to {(out - want).abs().max().item():.3g}")
    print(f"ms a solve (T={T}, {valid} valid, CUDA events over {ROUNDS} solves, in turns "
          f"a, b, b, a; {card}): "
          + "; ".join(f"{k} graph {', '.join(f'{t:.3f}' for t in v)}" for k, v in times.items())
          + "; the same mel to the bit")


if __name__ == "__main__":
    main()

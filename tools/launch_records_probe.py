#!/usr/bin/env python3
"""torch.profiler's kernel and launch-API records for K3 (the PyTorch
port's DiT attention, indextts_tpu_torch/csrc/dit_attention.cu), its
bfloat16 and float32 instantiations alone, on one NVIDIA GPU:

  PYTHONPATH=. python3 tools/launch_records_probe.py

Builds the kernels (chip_smoke.environment), draws chip_smoke.py's main
K3-bf16 case (B=2, H=8, T=898, 774 valid) and profiles windows of 48, 96,
1 and 2 calls, with CUDA activity only, with CPU activity too, and with a
small torch kernel before the calls; prints each window's device-kernel
records and host launch-API records by name. chip_smoke.py `one_launch`
expects one of each a call; this shows whether records go missing when
the kernel is profiled without the profiles that come before it there.
"""

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from indextts_tpu_torch.config import load_config
from indextts_tpu_torch.ops import dit_attention as k3


def window(fn, calls: int, activities, sentinel: bool = False):
    """({kernel name: records}, {launch API name: records}) of `calls`
    fn() calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if sentinel:
            torch.ones(8, device="cuda").add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, launches = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name[:50]] = kernels.get(e.name[:50], 0) + 1
        elif "LaunchKernel" in e.name:
            launches[e.name] = launches.get(e.name, 0) + 1
    return kernels, launches


def main():
    card = chip_smoke.environment()
    cfg = load_config()
    shapes = chip_smoke.main_path_shapes(cfg, chip_smoke.MAX_MEL_TOKENS)
    longest = chip_smoke.main_path_shapes(cfg, cfg.runtime.max_mel_tokens)
    heads = cfg.s2mel.dit.num_heads
    g = torch.Generator(device="cuda").manual_seed(33)
    name, t, rows = next(c for c in chip_smoke.k3_bf16_cases(shapes, longest)
                         if c[0] == "main")
    q, k, v, mask, _ = chip_smoke.k3_bf16_inputs(g, name, t, rows, heads)
    q32, k32, v32 = q.float(), k.float(), v.float()
    cuda_only = [ProfilerActivity.CUDA]
    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, fn in (("bf16", lambda: k3.dit_attention(q, k, v, mask)),
                      ("fp32", lambda: k3.dit_attention(q32, k32, v32, mask))):
        for calls, activities, sentinel in ((48, cuda_only, False), (48, cuda_only, False),
                                            (48, both, False), (48, cuda_only, True),
                                            (96, cuda_only, False), (1, cuda_only, False),
                                            (2, cuda_only, False)):
            kernels, launches = window(fn, calls, activities, sentinel)
            print(f"{label} calls={calls} cpu={len(activities) == 2} sentinel={sentinel}: "
                  f"kernels {kernels}; launch records {launches}")
    print(card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device times of K9 and K10, the PyTorch port's DiT attention backward
kernels (indextts_tpu_torch/csrc/dit_attention_bwd.cu), for the port of
any tree, on one NVIDIA GPU:

  python3 tools/dit_bwd_times.py [TREE]

TREE (default: this repository) holds the `indextts_tpu_torch` that is
timed, for example a parent commit unpacked with `git archive` into
build/. The timing code is always this repository's chip_smoke.py
(`time_k9_k10`: K9, K10, D = rowsum(dO o O) and K9 + K10 + D by CUDA
events over graph replays, SDPA's one backward of dq, dk and dv by events
over eager calls) at the main path's solve (B=2, H=8, T=898, 774 valid),
the longest segment's (T=2946, 2838 valid) and a batched solve's 16 rows,
on inputs drawn alike for every tree, so two trees run in turns on one
card (parent, change, change, parent) are timed alike. Prints the card's
name and power limit first, and each kernel's registers and local (spill)
bytes where the tree's port reports them.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    if len(sys.argv) > 2:
        raise SystemExit(f"dit_bwd_times: takes at most one tree, got {sys.argv[1:]}")
    tree = Path(sys.argv[1] if len(sys.argv) == 2 else HERE).resolve()
    if not (tree / "indextts_tpu_torch").is_dir():
        raise SystemExit(f"dit_bwd_times: no indextts_tpu_torch in {tree}")
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dit_bwd_times: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    import indextts_tpu_torch
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.ops import dit_attention as k3

    print(f"timing the port in {Path(indextts_tpu_torch.__file__).parent.parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config()
    heads = cfg.s2mel.dit.num_heads
    cases = cs.k9_k10_cases(cs.main_path_shapes(cfg, cs.MAX_MEL_TOKENS),
                            cs.main_path_shapes(cfg, cfg.runtime.max_mel_tokens))
    g = torch.Generator(device="cuda").manual_seed(9)
    for name, t, rows in cases:
        if name == "main" or name.startswith("longest") or name == "batched 16 rows":
            cs.time_k9_k10(name, cs.k9_k10_inputs(g, name, t, rows, heads), heads, full=False)
    if hasattr(k3, "bwd_attributes"):
        for kname, (regs, local) in k3.bwd_attributes().items():
            print(f"{kname}: {regs} registers a thread, {local} bytes of local memory a thread")


if __name__ == "__main__":
    main()

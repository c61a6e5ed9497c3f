#!/usr/bin/env python3
"""Device times of K3-bf16, the PyTorch port's bfloat16 DiT attention
(indextts_tpu_torch/csrc/dit_attention.cu `dit_attention_bf16`), for the
port of any tree, on one NVIDIA GPU:

  python3 tools/dit_times.py [TREE]

TREE (default: this repository) holds the `indextts_tpu_torch` that is
timed, for example a parent commit unpacked with `git archive` into
build/. The timing code is always this repository's chip_smoke.py
(`time_k3_bf16`: K3-bf16 in turns with the float32 instantiation, its
plain version and SDPA on the bfloat16 tensors, by CUDA events over graph
replays) at the main path's solve (B=2, H=8, T=898, 774 valid), the
longest segment's (T=2946, 2838 valid) and a batched solve's 16 rows, on
inputs drawn alike for every tree, so two trees run in turns on one card
(parent, change, change, parent) are timed alike. Prints the card's name
and power limit first, then a checksum of the float32 K3's output and row
statistics on fixed inputs (the main path's solve), which is equal on two
trees whose float32 instantiation computes the same bits, and the bfloat16
kernel's registers and local (spill) bytes where the tree's port reports
them.
"""

from __future__ import annotations

import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def checksum(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    if len(sys.argv) > 2:
        raise SystemExit(f"dit_times: takes at most one tree, got {sys.argv[1:]}")
    tree = Path(sys.argv[1] if len(sys.argv) == 2 else HERE).resolve()
    if not (tree / "indextts_tpu_torch").is_dir():
        raise SystemExit(f"dit_times: no indextts_tpu_torch in {tree}")
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dit_times: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    import indextts_tpu_torch
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.ops import dit_attention as k3

    print(f"timing the port in {Path(indextts_tpu_torch.__file__).parent.parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config()
    heads = cfg.s2mel.dit.num_heads
    shapes = cs.main_path_shapes(cfg, cs.MAX_MEL_TOKENS)
    g = torch.Generator(device="cuda").manual_seed(3)
    T, tv = shapes["dit_T"], shapes["dit_valid"]
    q, k, v = cs.dit_qkv(g, 2, heads, T)
    mask = cs.key_mask(T, [tv, tv])
    out, stats = k3.dit_attention_stats(q, k, v, mask)
    print(f"K3 float32 (B=2, H={heads}, T={T}, {tv} valid) checksums: output "
          f"{checksum(k3.dit_attention(q, k, v, mask))}, output with statistics "
          f"{checksum(out)}, statistics {checksum(stats)}")
    cases = cs.k3_bf16_cases(shapes, cs.main_path_shapes(cfg, cfg.runtime.max_mel_tokens))
    g = torch.Generator(device="cuda").manual_seed(33)
    for name, t, rows in cases:
        inputs = cs.k3_bf16_inputs(g, name, t, rows, heads)
        if name == "main" or name.startswith("longest") or name == "batched 16 rows":
            cs.time_k3_bf16(name, inputs, heads)
    if hasattr(k3, "bf16_attributes"):
        print(f"K3-bf16 (registers a thread at launch, local bytes a thread): "
              f"{k3.bf16_attributes()}")


if __name__ == "__main__":
    main()

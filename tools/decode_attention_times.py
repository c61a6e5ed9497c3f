#!/usr/bin/env python3
"""Device times of K1 and K4, the PyTorch port's decode attention kernels
(indextts_tpu_torch/csrc/decode_attention.cu), for the port of any tree,
on one NVIDIA GPU:

  python3 tools/decode_attention_times.py [TREE]

TREE (default: this repository) holds the `indextts_tpu_torch` that is
timed, for example a parent commit unpacked with `git archive` into
build/. The timing code is always this repository's chip_smoke.py
(`time_k1`, `time_k4`: CUDA events over graph replays of calls that cycle
more than 100 MB of caches, at the main path's last step and at cap 1657
with valid 1657, 1000 and 400), so two trees run in turns on one card
are timed alike. Prints the card's name and power limit first.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main():
    if len(sys.argv) > 2:
        raise SystemExit(f"decode_attention_times: takes at most one tree, got {sys.argv[1:]}")
    tree = Path(sys.argv[1] if len(sys.argv) == 2 else HERE).resolve()
    if not (tree / "indextts_tpu_torch").is_dir():
        raise SystemExit(f"decode_attention_times: no indextts_tpu_torch in {tree}")
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from indextts_tpu_torch.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_times: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    import indextts_tpu_torch

    print(f"timing the port in {Path(indextts_tpu_torch.__file__).parent.parent}")
    cfg = load_config()
    cap = cs.main_path_shapes(cfg, cs.MAX_MEL_TOKENS)["decode_cap"]
    cs.time_k1(cap, cfg.gpt.layers, cfg.gpt.heads, yardsticks=False)
    cs.time_k4(cap, cfg.gpt.layers, cfg.gpt.heads, yardsticks=False)


if __name__ == "__main__":
    main()

"""Where the port puts what it compiles at run time: the CUDA kernels
(ops/cuda_lib.py) and the native host DSP library (utils/native.py)."""

from __future__ import annotations

import os
from pathlib import Path


def build_dir() -> Path:
    """INDEXTTS_TORCH_BUILD_DIR, else `build/torch_kernels` at the repo root."""
    env = os.environ.get("INDEXTTS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"

"""Environment check for the port: the counterpart of the JAX package's
tools/env_check.py.

  python -m indextts_tpu_torch.tools.env_check               # the card
  python -m indextts_tpu_torch.tools.env_check --device cpu  # the CPU route

Prints one JSON object: torch's version and the CUDA version it was built
with; the device's name, power limit (nvidia-smi) and count; nvcc's version
and whether g++ is there; on the card, each csrc/ kernel library built and
loaded through ops/cuda_lib.py (`build`, `load`), by name; the native host
DSP (utils/native.py), built or the error it raised; numpy, scipy, einops
and triton, each its version or null; and a 128 x 128 ones matmul on the
device, whose sum must be 128^3.

Exits 1 where there is no card and no `--device cpu`, where a kernel does
not build or load, or where the matmul check fails; 0 otherwise. On the CPU
no kernel is built: its route runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import subprocess
import sys


def _run(cmd) -> str:
    """The first line of `cmd`'s output that says something, or the error
    that running it raised."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"error: {e}"
    lines = [line.strip() for line in (out.stdout + out.stderr).splitlines() if line.strip()]
    if out.returncode:
        return f"error: exit {out.returncode}: {lines[-1] if lines else ''}"
    return lines[-1] if lines else ""


def check(device: str) -> dict:
    """The report; `ok` says whether the environment passed."""
    import torch

    from indextts_tpu_torch.ops import cuda_lib
    from indextts_tpu_torch.utils import native

    out = {"torch": torch.__version__, "cuda_built": torch.version.cuda,
           "device": device, "cuda_available": torch.cuda.is_available(),
           "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0}
    failures = []
    if device == "cuda":
        if torch.cuda.is_available():
            out["device_name"] = torch.cuda.get_device_name(0)
        else:
            failures.append("no CUDA device (pass --device cpu for the CPU route)")
    smi = shutil.which("nvidia-smi")
    out["nvidia_smi"] = _run([smi, "--query-gpu=name,power.limit",
                              "--format=csv,noheader"]) if smi else None
    try:
        out["nvcc"] = _run([cuda_lib.nvcc_path(), "--version"])
    except RuntimeError as e:
        out["nvcc"] = f"error: {e}"
    out["gxx"] = shutil.which("g++") is not None

    if device == "cuda" and not failures:
        kernels = {}
        for name in cuda_lib.SOURCES:
            try:
                cuda_lib.load(name)
                kernels[name] = "ok"
            except (RuntimeError, OSError) as e:
                kernels[name] = f"error: {e}"
                failures.append(f"kernel {name} did not build or load")
        out["kernels"] = kernels
    else:
        out["kernels"] = None
    try:
        native.lib()
        out["native_dsp"] = "ok"
    except RuntimeError as e:
        out["native_dsp"] = f"error: {e}"

    for mod in ("numpy", "scipy", "einops", "triton"):
        try:
            out[mod] = getattr(importlib.import_module(mod), "__version__", "present")
        except ImportError:
            out[mod] = None

    if not failures:
        x = torch.ones((128, 128), device=device)
        y = float((x @ x).sum())
        out["matmul_check"] = "ok" if y == 128.0 ** 3 else f"BAD ({y})"
        if y != 128.0 ** 3:
            failures.append("matmul check")
    out["failures"] = failures
    out["ok"] = not failures
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU route")
    args = p.parse_args(argv)
    out = check(args.device)
    print(json.dumps(out, indent=2))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

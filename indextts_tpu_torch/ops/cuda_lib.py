"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for `sm_90a` into its own shared library with
a plain C interface, loaded with ctypes. Libraries go into a build directory
keyed by the hash of the source and the flags, so a changed source rebuilds
and an unchanged one loads as is. `build()` starts one nvcc per source at
once; a wrapper's first launch builds only its own library.

Every C entry point returns `cudaGetLastError()` after its launch; `check()`
raises on a non-zero code. Each wrapper counts its launches on a
`LaunchCounter`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("decode_attention", "snake", "dit_attention", "dit_attention_bwd", "gemv")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_LOCK = threading.Lock()
# one CUDA graph capture at a time in the process: torch.cuda.graph begins
# with a device-wide synchronize, which ends a capture another thread has
# under way
_CAPTURE_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    """INDEXTTS_TORCH_BUILD_DIR, else `build/torch_kernels` at the repo root."""
    env = os.environ.get("INDEXTTS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "torch_kernels"


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def _so_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    common = (CSRC / "common.cuh").read_bytes()
    h = hashlib.sha256(src + common + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{h}.so"


def _nvcc_cmd(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile each source in `names` that has no up-to-date library, one
    nvcc per source, all in parallel. Raises with nvcc's output if a build
    fails. Returns each name's library path."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _so_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _nvcc_cmd(name, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} ---\n{log}")
            continue
        os.replace(tmp, out)
        if verbose and log:
            print(f"[nvcc {name}]\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _so_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point `symbol` of library `name`, its signature set once;
    every entry point returns an int error code."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


class LaunchCounter:
    """The launches of one kernel; its wrapper calls `add()` where it
    launches it. A call made while this thread's current stream captures
    a CUDA graph launches nothing: it goes to the thread's tally, which the
    capturing code takes (`take_captured`) and adds once a replay
    (`add_replayed`). So a capture counts nothing, and another thread's
    launches during it count as they happen. Adds take a lock, so threads
    lose none."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def add(self) -> None:
        if torch.cuda.is_current_stream_capturing():
            self._local.captured = getattr(self._local, "captured", 0) + 1
        else:
            self.add_replayed(1)

    def add_replayed(self, n: int) -> None:
        with self._lock:
            self.launches += n

    def take_captured(self) -> int:
        """This thread's calls recorded under capture since its last take."""
        n = getattr(self._local, "captured", 0)
        self._local.captured = 0
        return n


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph", stream: "torch.cuda.Stream", pool=None):
    """Capture `graph` on `stream` (into the memory pool `pool`, else its
    own) as the process's only capture while it lasts. thread_local: other
    threads' CUDA calls, replays included, go on meanwhile."""
    with _CAPTURE_LOCK, torch.cuda.graph(graph, pool=pool, stream=stream,
                                        capture_error_mode="thread_local"):
        yield


def pool_bytes(pool) -> int:
    """Device memory that the graph memory pool `pool` holds (its
    segments)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

"""Observability: staged logging, request boxes, device-memory tracking,
graceful shutdown, stage timers and a profiler trace.

Copy of indextts_tpu/utils/obs.py (reference indextts/logging.py:
setup_logging :78, print_stage :52, print_request_start/complete
:197-249, GracefulShutdown :252-297; utils/vram_utils.py VRAMTracker
:129-177, VRAMProfiler :93-126). The HBM names stay; on the card they read
the CUDA caching allocator (`torch.cuda.memory_stats`), and `torch_trace`
takes the place of `jax_trace`. The device-memory gauge of /metrics is
the server's own (runtime/server.py).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import signal
import sys
import tempfile
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

_LOGGER: Optional[logging.Logger] = None

ANSI = {"reset": "\033[0m", "green": "\033[32m", "red": "\033[31m", "cyan": "\033[36m"}


class _StderrHandler(logging.StreamHandler):
    """The console handler: writes to whatever sys.stderr is when a record
    comes, so a logger set up once outlives a redirected stderr."""

    def emit(self, record):
        self.stream = sys.stderr
        super().emit(record)


def setup_logging(name: str = "indextts_tpu_torch", log_dir: str = "logs",
                  level: int = logging.INFO, file_logging: bool = True) -> logging.Logger:
    """Console + 10 MB rotating file logger (logging.py:78-120)."""
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = _StderrHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if file_logging:
        try:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{name}.log"), maxBytes=10 * 1024 * 1024,
                backupCount=3)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:  # a read-only working directory: the console only
            pass
    _LOGGER = logger
    return logger


def get_logger() -> logging.Logger:
    return _LOGGER or setup_logging()


def print_stage(message: str, status: str = "progress", elapsed: Optional[float] = None,
                message_extra: str = ""):
    """Stage banner lines (logging.py:52-75)."""
    icon = {"progress": "…", "complete": "✓", "failed": "✗"}.get(status, "•")
    color = {"progress": "cyan", "complete": "green", "failed": "red"}.get(status, "reset")
    t = f" ({elapsed:.2f}s)" if elapsed is not None else ""
    extra = f" — {message_extra}" if message_extra else ""
    get_logger().info(f"{ANSI[color]}{icon}{ANSI['reset']} {message}{t}{extra}")


def print_request_box(request_id: str, text_preview: str, duration: Optional[float] = None,
                      audio_len: Optional[float] = None, rtf: Optional[float] = None,
                      done: bool = False):
    """Request start/complete boxes (logging.py:197-249)."""
    log = get_logger()
    head = "REQUEST COMPLETE" if done else "REQUEST START"
    lines = [f"┌─ {head} [{request_id}] " + "─" * 20]
    lines.append(f"│ text: {text_preview[:60]!r}")
    if done:
        if duration is not None:
            lines.append(f"│ wall: {duration:.2f}s")
        if audio_len is not None:
            lines.append(f"│ audio: {audio_len:.2f}s")
        if rtf is not None:
            lines.append(f"│ rtf: {rtf:.3f}")
    lines.append("└" + "─" * 40)
    for ln in lines:
        log.info(ln)


# ---------------------------------------------------------------------------
# Device-memory tracking (vram_utils.py VRAMTracker/VRAMProfiler)
# ---------------------------------------------------------------------------


def get_hbm_usage(device=None) -> Dict[str, float]:
    """Bytes in use, their peak and the card's total for `device` (default:
    the current CUDA device), in GB, from the caching allocator's
    statistics; {} for a CPU device or without a card, as the JAX gauge
    without a device. `source` names the gauge, as in JAX."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"gb_in_use": stats.get("allocated_bytes.all.current", 0) / 1e9,
            "peak_gb_in_use": stats.get("allocated_bytes.all.peak", 0) / 1e9,
            "gb_limit": total / 1e9, "source": "memory_stats"}


class HBMTracker:
    """Snapshot device memory per model load (VRAMTracker :129-177)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = device
        self.snapshots: List[Dict] = []

    def snapshot(self, tag: str, model_name: str = ""):
        if not self.enabled:
            return
        u = get_hbm_usage(self.device)
        self.snapshots.append({"tag": tag, "model": model_name, **u})
        if u:
            get_logger().info(
                f"[hbm] {tag}: in_use={u.get('gb_in_use', 0):.2f}GB "
                f"peak={u.get('peak_gb_in_use', 0):.2f}GB")

    def report(self) -> List[Dict]:
        return list(self.snapshots)


@contextmanager
def hbm_profile(tag: str, device=None):
    """Block profiler (VRAMProfiler :93-126)."""
    before = get_hbm_usage(device)
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    after = get_hbm_usage(device)
    delta = after.get("gb_in_use", 0) - before.get("gb_in_use", 0)
    get_logger().info(f"[hbm] {tag}: {dt:.2f}s, Δ{delta:+.2f}GB")


class StageTimers:
    """Accumulating wall-clock stage timers (infer_v2.py:726-729 pattern)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextmanager
    def track(self, stage: str):
        t0 = time.perf_counter()
        yield
        self.totals[stage] = self.totals.get(stage, 0.0) + time.perf_counter() - t0

    def report(self) -> Dict[str, float]:
        return dict(self.totals)


class GracefulShutdown:
    """SIGINT/SIGTERM two-stage shutdown (logging.py:252-297): the first
    signal runs the registered callbacks, the second exits."""

    def __init__(self):
        self.requested = False
        self._callbacks: List[Callable[[], None]] = []
        self._orig = {}

    def register(self, cb: Callable[[], None]):
        self._callbacks.append(cb)

    def install(self):
        try:
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._orig[sig] = signal.signal(sig, self._handler)
        except ValueError:
            # signal handlers can only be set on the main thread; a server
            # run on a worker thread handles its shutdown itself
            get_logger().info("GracefulShutdown: not on main thread; skipped")
        return self

    def _handler(self, signum, frame):
        if self.requested:
            get_logger().warning("forced shutdown")
            raise SystemExit(130)
        self.requested = True
        get_logger().info("shutdown requested; finishing in-flight work "
                          "(signal again to force)")
        for cb in self._callbacks:
            try:
                cb()
            except Exception:  # one failing callback must not stop the others
                get_logger().exception("shutdown callback failed")


@contextmanager
def torch_trace(log_dir: Optional[str] = None):
    """torch.profiler over the block, CPU activity and, with a card, CUDA,
    written as a Chrome trace `trace_<pid>_<ms>.json` into `log_dir`
    (default: torch_trace in the temporary directory); yields log_dir
    (`jax_trace`'s counterpart)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))

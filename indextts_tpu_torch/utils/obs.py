"""Observability for the server's start-up: staged logging and graceful
shutdown.

Copy of the parts of indextts_tpu/utils/obs.py that serve.py uses
(reference indextts/logging.py: setup_logging :78, print_stage :52,
GracefulShutdown :252-297). The device-memory gauge of /metrics is the
server's own (runtime/server.py).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import signal
import sys
from typing import Callable, List, Optional

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

"""ctypes bindings for the port's native host DSP (csrc/dsp.cpp).

Counterpart of indextts_tpu/utils/native.py. The library is built with
`g++ -O3 -shared -fPIC` on first use into the port's build directory
(utils/build.py `build_dir()`, shared with the CUDA kernels), named by the
hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads as is. The
compiler writes a file of its own process's name, which is then renamed
into place, so processes that build at once do not read a half-written
library. Unlike the JAX package, a failed build or load raises with the
compiler's output: no silent numpy fallback. Whether the native path is
taken is decided by INDEXTTS_NATIVE_DSP at the call sites
(frontend/features.py, utils/audio.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from indextts_tpu_torch.utils.build import build_dir

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dsp.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def so_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"libindextts_dsp_{h}.so"


def build() -> Path:
    """The library's path, compiling it unless it is there. Raises with the
    compiler's output if the build fails."""
    out = so_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native DSP build failed: {' '.join(cmd)}: {e}") from e
    if p.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native DSP build failed: {' '.join(cmd)}\n{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use, its signatures set."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                dll = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"native DSP library {path} failed to load: {e}") from e
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
            dll.kaldi_fbank.argtypes = [
                f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, f32p,
            ]
            dll.kaldi_fbank.restype = ctypes.c_int
            dll.resample_poly.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                          f32p]
            dll.resample_poly.restype = ctypes.c_int64
            dll.pcm16_to_float.argtypes = [i16p, ctypes.c_int64, f32p]
            dll.pcm16_to_float.restype = None
            dll.float_to_pcm16.argtypes = [f32p, ctypes.c_int64, i16p]
            dll.float_to_pcm16.restype = None
            _LIB = dll
        return _LIB


def kaldi_fbank(
    wav: np.ndarray,
    num_mel_bins: int = 80,
    sample_rate: int = 16000,
    frame_length: int = 400,
    hop: int = 160,
    fft_length: int = 512,
    preemphasis: float = 0.97,
    low_freq: float = 20.0,
    high_freq: Optional[float] = None,
    mel_floor: float = 1.192092955078125e-07,
) -> np.ndarray:
    """(T,) waveform -> (frames, num_mel_bins) float32 log-mel, the
    semantics of frontend/features.py `kaldi_fbank_core`, computed in
    float64 from the float32 samples."""
    if fft_length & (fft_length - 1) or fft_length < frame_length:
        raise ValueError(f"fft_length {fft_length}: a power of two >= frame_length "
                         f"{frame_length}")
    dll = lib()
    wav = np.ascontiguousarray(np.atleast_1d(np.squeeze(wav)), dtype=np.float32)
    if high_freq is None:
        high_freq = sample_rate / 2
    n_frames = max(0, 1 + (len(wav) - frame_length) // hop)
    out = np.empty((n_frames, num_mel_bins), np.float32)
    if n_frames:
        got = dll.kaldi_fbank(wav, len(wav), num_mel_bins, sample_rate, frame_length, hop,
                              fft_length, preemphasis, low_freq, high_freq, mel_floor, out)
        if got != n_frames:
            raise RuntimeError(f"native kaldi_fbank wrote {got} frames, expected {n_frames}")
    return out


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling with scipy.signal.resample_poly's FIR and
    alignment (its answers to float32 rounding)."""
    x = np.ascontiguousarray(np.atleast_1d(np.squeeze(x)), dtype=np.float32)
    if sr_in == sr_out:
        return x
    g = int(np.gcd(sr_in, sr_out))
    up, down = sr_out // g, sr_in // g
    out = np.empty((len(x) * up + down - 1) // down, np.float32)
    n = lib().resample_poly(x, len(x), up, down, out)
    return out[:n]


def float_to_pcm16(x: np.ndarray) -> np.ndarray:
    """float32 -> int16, clamp(32767 x) truncated toward zero."""
    x = np.ascontiguousarray(np.atleast_1d(np.squeeze(x)), dtype=np.float32)
    out = np.empty(len(x), np.int16)
    lib().float_to_pcm16(x, len(x), out)
    return out


def pcm16_to_float(x: np.ndarray) -> np.ndarray:
    """int16 -> float32 x / 32768."""
    x = np.ascontiguousarray(np.atleast_1d(np.squeeze(x)), dtype=np.int16)
    out = np.empty(len(x), np.float32)
    lib().pcm16_to_float(x, len(x), out)
    return out

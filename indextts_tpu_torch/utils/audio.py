"""Audio I/O + resampling (host-side).

Replaces the reference's librosa.load / torchaudio Resample / torchaudio.save
(infer_v2.py:510-522, 628-630, 912) with scipy + numpy. INDEXTTS_NATIVE_DSP
routes work to the native host library (utils/native.py) as in the JAX
package: the streaming PCM16 conversion unless it is "0", the resampler
only under "all" (scipy's FIR, its answers to float32 rounding)."""

from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from indextts_tpu_torch.utils import native


def load_wav(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Load a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        x = resample(x, sr, target_sr)
        sr = target_sr
    return x, sr


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return x
    if os.environ.get("INDEXTTS_NATIVE_DSP") == "all":
        return native.resample(x, sr_in, sr_out)
    g = np.gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def save_wav(path: str, waveform: np.ndarray, sr: int):
    """float waveform in [-1, 1] (or already int16-scaled) -> 16-bit PCM WAV."""
    w = np.asarray(waveform)
    if w.dtype != np.int16:
        if np.abs(w).max() <= 1.5:  # [-1, 1] float
            w = np.clip(w * 32767.0, -32767, 32767)
        w = w.astype(np.int16)
    wavfile.write(path, sr, w)


def wav_bytes(waveform: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    save_wav_buffer(buf, waveform, sr)
    return buf.getvalue()


def save_wav_buffer(buf, waveform: np.ndarray, sr: int):
    w = np.asarray(waveform)
    if w.dtype != np.int16:
        if np.abs(w).max() <= 1.5:
            w = np.clip(w * 32767.0, -32767, 32767)
        w = w.astype(np.int16)
    wavfile.write(buf, sr, w)


def pcm16_bytes(waveform: np.ndarray) -> bytes:
    """Raw s16le PCM chunk (streaming endpoint payload, serve_tars.py:345-438)."""
    w = np.asarray(waveform)
    if w.dtype != np.int16:
        if np.abs(w).max() <= 1.5:
            if os.environ.get("INDEXTTS_NATIVE_DSP", "1") != "0":
                return native.float_to_pcm16(w).tobytes()
            w = np.clip(w * 32767.0, -32767, 32767)
        w = w.astype(np.int16)
    return w.tobytes()

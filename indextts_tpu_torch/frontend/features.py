"""Kaldi-compliant fbank feature extraction (host-side numpy).

Two consumers, both 16 kHz:
  * w2v-BERT conditioning: SeamlessM4TFeatureExtractor semantics
    (reference: infer_v2.py:632-637) — 80 mel bins, povey window, preemphasis,
    per-mel-bin normalization, stride-2 frame stacking to 160 dims.
  * CAMPPlus style vector: torchaudio.compliance.kaldi.fbank semantics
    (reference: infer_v2.py:642-647) — 80 mel bins, dither=0, raw log-mel
    (CAMPPlus mean-subtracts per coefficient downstream, so absolute input
    scaling cancels).

Implemented from the Kaldi spec. As in the JAX package, both consumers
take the fbank of the native host library (csrc/dsp.cpp through
utils/native.py) unless INDEXTTS_NATIVE_DSP is "0"; `kaldi_fbank_core` is
the numpy version, within 1e-4 of it.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np

from indextts_tpu_torch.utils import native


def _fbank_dispatch(waveform: np.ndarray, **kw) -> np.ndarray:
    """The native fbank (float32 samples in) unless INDEXTTS_NATIVE_DSP is
    "0", then the numpy one (JAX frontend/features.py `_fbank_dispatch`).
    A native library that fails to build or load raises."""
    if os.environ.get("INDEXTTS_NATIVE_DSP", "1") != "0":
        return native.kaldi_fbank(np.asarray(waveform, np.float32), **kw)
    return kaldi_fbank_core(waveform, **kw)


def povey_window(length: int) -> np.ndarray:
    n = np.arange(length, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))) ** 0.85).astype(
        np.float64
    )


def hz_to_mel_kaldi(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_kaldi(m):
    return 700.0 * (np.exp(np.asarray(m, dtype=np.float64) / 1127.0) - 1.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_filters(
    num_bins: int, fft_length: int, sample_rate: int, low_freq: float, high_freq: float
) -> np.ndarray:
    """Kaldi-style triangular filters computed in mel space
    (transformers.audio_utils.mel_filter_bank(mel_scale='kaldi',
    triangularize_in_mel_space=True, norm=None) semantics).
    Returns (n_freqs, num_bins)."""
    n_freqs = fft_length // 2 + 1
    low_mel = hz_to_mel_kaldi(low_freq)
    high_mel = hz_to_mel_kaldi(high_freq)
    mel_points = np.linspace(low_mel, high_mel, num_bins + 2)
    # triangularize in mel space: use fft BIN indices mapped to mel
    fft_bin_width = sample_rate / fft_length
    fftfreqs = hz_to_mel_kaldi(fft_bin_width * np.arange(n_freqs))

    fdiff = np.diff(mel_points)
    ramps = mel_points.reshape(-1, 1) - fftfreqs.reshape(1, -1)
    down = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    up = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(np.zeros(1), np.minimum(down, up))  # (num_bins, n_freqs)
    return weights.T.astype(np.float32)


def _frame(
    waveform: np.ndarray, frame_length: int, hop: int
) -> np.ndarray:
    num_frames = 1 + (len(waveform) - frame_length) // hop if len(waveform) >= frame_length else 0
    idx = np.arange(frame_length)[None, :] + hop * np.arange(num_frames)[:, None]
    return waveform[idx]


def kaldi_fbank_core(
    waveform: np.ndarray,
    num_mel_bins: int = 80,
    sample_rate: int = 16000,
    frame_length: int = 400,
    hop: int = 160,
    fft_length: int = 512,
    preemphasis: float = 0.97,
    low_freq: float = 20.0,
    high_freq: Optional[float] = None,
    mel_floor: float = 1.192092955078125e-07,
    window: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(T,) float waveform -> (frames, num_mel_bins) log-mel, kaldi semantics:
    snip_edges framing, per-frame DC removal, preemphasis with edge
    replication, povey window, power spectrum, mel, log with floor."""
    if high_freq is None:
        high_freq = sample_rate / 2
    if window is None:
        window = povey_window(frame_length)
    frames = _frame(np.asarray(waveform, dtype=np.float64), frame_length, hop)
    # remove DC offset per frame
    frames = frames - frames.mean(axis=1, keepdims=True)
    # preemphasis: x[i] -= coef * x[i-1], x[0] -= coef * x[0]
    pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames - preemphasis * pre
    frames = frames * window[None, :]
    spec = np.fft.rfft(frames, n=fft_length, axis=1)
    power = np.abs(spec) ** 2
    fb = kaldi_mel_filters(num_mel_bins, fft_length, sample_rate, low_freq, high_freq)
    mel = power @ fb.astype(np.float64)
    return np.log(np.maximum(mel, mel_floor)).astype(np.float32)


def seamless_features(
    waveform_16k: np.ndarray, stride: int = 2, pad_to_multiple_of: int = 2
) -> Tuple[np.ndarray, np.ndarray]:
    """SeamlessM4TFeatureExtractor.__call__ semantics for a single waveform.

    Returns (input_features (1, T//2, 160), attention_mask (1, T//2))."""
    wav = np.squeeze(np.asarray(waveform_16k, dtype=np.float32)) * (2 ** 15)
    feats = _fbank_dispatch(wav)
    # per-mel-bin zero-mean unit-var (ddof=1)
    feats = (feats - feats.mean(0, keepdims=True)) / np.sqrt(
        feats.var(0, ddof=1, keepdims=True) + 1e-7
    )
    T = feats.shape[0]
    pad = (-T) % pad_to_multiple_of
    mask = np.ones(T + pad, dtype=np.int32)
    if pad:
        feats = np.pad(feats, ((0, pad), (0, 0)))
        mask[T:] = 0
    n = feats.shape[0] - feats.shape[0] % stride
    feats = feats[:n].reshape(1, n // stride, feats.shape[1] * stride)
    mask = mask[:n][np.arange(n) % stride == 1][None]
    return feats.astype(np.float32), mask


def campplus_fbank(waveform_16k: np.ndarray) -> np.ndarray:
    """torchaudio.compliance.kaldi.fbank(num_mel_bins=80, dither=0,
    sample_frequency=16000) equivalent, with the CAMPPlus-side per-coefficient
    mean subtraction applied by the caller. Returns (frames, 80)."""
    wav = np.squeeze(np.asarray(waveform_16k, dtype=np.float64))
    # torchaudio kaldi uses energy_floor eps; log-mel floor is tiny
    return _fbank_dispatch(wav, mel_floor=1.1920928955078125e-07)

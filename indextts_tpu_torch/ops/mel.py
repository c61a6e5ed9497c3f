"""STFT + log-mel spectrogram as matmuls against a windowed real-DFT basis.

Parity target: the reference's `mel_spectrogram`
(indextts/s2mel/modules/audio.py:45-82), as the JAX package computes it in
indextts_tpu/ops/mel.py: reflect-pad by (n_fft-hop)/2, STFT with center=False
and a periodic hann window, magnitude sqrt(re^2 + im^2 + 1e-9), slaney mel
filterbank (librosa semantics), log with a 1e-5 clamp. The filterbank and
basis helpers are numpy copies of that module.

`mel_spectrogram_v1` is the IndexTTS v1 conditioning mel (JAX
`mel_spectrogram_v1`, indextts_tpu/ops/mel.py:192-207): torchaudio's
MelSpectrogram as the reference's MelSpectrogramFeatures uses it, centred
(reflect pad n_fft // 2), the power-1 magnitude with no epsilon, an HTK
filterbank with no norm, log clipped at 1e-7.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from indextts_tpu_torch.config import MelConfig
from indextts_tpu_torch.models.layers import reflect_pad


def hz_to_mel(frequencies, htk: bool = False):
    """librosa-compatible Hz->mel. Slaney formula by default."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = frequencies >= min_log_hz
        mels[log_t] = min_log_mel + np.log(frequencies[log_t] / min_log_hz) / logstep
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, librosa.filters.mel semantics.

    Returns (n_mels, 1 + n_fft//2) float32."""
    if fmax is None:
        fmax = float(sr) / 2
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sr) / 2, n_freq, endpoint=True)

    min_mel = hz_to_mel(fmin, htk=htk)
    max_mel = hz_to_mel(fmax, htk=htk)
    mels = np.linspace(min_mel, max_mel, n_mels + 2)
    mel_f = mel_to_hz(mels, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    weights = np.zeros((n_mels, n_freq), dtype=np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]

    return weights.astype(np.float32)


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """torch.hann_window semantics (periodic by default)."""
    if periodic:
        n = np.arange(win_length, dtype=np.float64)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    else:
        w = np.hanning(win_length)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> tuple:
    """Real-DFT basis matrices (n_fft, n_freq) with the window folded in."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    win = hann_window(win_length).astype(np.float64)
    if win_length < n_fft:
        # torch.stft centers the window inside the frame
        pad_l = (n_fft - win_length) // 2
        win = np.pad(win, (pad_l, n_fft - win_length - pad_l))
    cos_b = (np.cos(ang) * win[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * win[:, None]).astype(np.float32)
    return cos_b, sin_b


def _basis(cfg: MelConfig, device: torch.device, v1: bool = False
           ) -> Tuple[torch.Tensor, ...]:
    """The DFT basis and the transposed filterbank on `device`: slaney, or
    with `v1` HTK with no norm."""
    key = (cfg, str(device), v1)
    got = _BASIS.get(key)
    if got is None:
        cos_b, sin_b = _dft_basis(cfg.n_fft, cfg.win_length)
        fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin,
                            cfg.fmax, htk=v1, norm=None if v1 else "slaney")
        got = tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb.T.copy()))
        _BASIS[key] = got
    return got


_BASIS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """y (B, T) float32 waveform at cfg.sample_rate -> (B, n_mels, frames)."""
    pad = (cfg.n_fft - cfg.hop_length) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = y.unfold(-1, cfg.n_fft, cfg.hop_length)  # (B, frames, n_fft)
    cos_b, sin_b, fb_t = _basis(cfg, y.device)
    real = frames @ cos_b
    imag = frames @ sin_b
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    mel = torch.log(torch.clamp(mag @ fb_t, min=1e-5))
    return mel.transpose(1, 2)


def mel_spectrogram_v1(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """y (B, T) float32 waveform at cfg.sample_rate -> (B, n_mels, frames),
    frames = T // hop + 1. The centre pad reflects as jnp.pad's does, also
    where it reaches past a short input (`reflect_pad`)."""
    y = reflect_pad(y, cfg.n_fft // 2)
    frames = y.unfold(-1, cfg.n_fft, cfg.hop_length)
    cos_b, sin_b, fb_t = _basis(cfg, y.device, v1=True)
    real = frames @ cos_b
    imag = frames @ sin_b
    mag = torch.sqrt(real * real + imag * imag)
    mel = torch.log(torch.clamp(mag @ fb_t, min=1e-7))
    return mel.transpose(1, 2)


def mel_frame_count(num_samples: int, cfg: MelConfig) -> int:
    """Number of mel frames `mel_spectrogram` produces for a T-sample input."""
    padded = num_samples + 2 * ((cfg.n_fft - cfg.hop_length) // 2)
    return 1 + (padded - cfg.n_fft) // cfg.hop_length

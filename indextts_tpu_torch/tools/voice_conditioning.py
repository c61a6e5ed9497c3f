"""Voice-conditioning preparation on the port: select and concatenate the
best prompt clips, and precompute the engine's speaker conditioning.

Counterpart of tools/voice_conditioning.py, with its subcommands, flags and
outputs:

  * `prepare` scores the clips of a directory (peak, rms, crest factor,
    silence ratio), picks the best until the target duration, joins them
    with fades and peak-normalizes them (numpy only);
  * `precompute` runs the port's `IndexTTS2Engine.prepare_speaker` on a
    prompt and writes its `SpeakerConditioning` as an .npz with the JAX
    tool's keys, so that a bundle written by either package loads in the
    other;
  * `load_precomputed_speaker(path, device)` reads such a bundle back into
    the port's SpeakerConditioning on a device.

  python -m indextts_tpu_torch.tools.voice_conditioning prepare --input-dir clips/ \\
      --output combined.wav --target-duration 12
  python -m indextts_tpu_torch.tools.voice_conditioning precompute --audio combined.wav \\
      --output spk.npz [--model-dir checkpoints] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from indextts_tpu_torch.utils.audio import load_wav, save_wav

KEYS = ("spk_cond_emb", "cond_len", "style", "prompt_condition", "ref_mel", "ref_mel_len",
        "spk_latents")


def quality_score(audio: np.ndarray, sr: int) -> dict:
    """Peak, rms, crest factor and silence ratio -> one scalar score: loud,
    low-silence, moderately compressed clips first; clipped audio (peak ~1)
    and very peaky audio are penalized."""
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    rms = float(np.sqrt(np.mean(audio ** 2))) if audio.size else 0.0
    crest = peak / rms if rms > 0 else 0.0
    silence_threshold = 10 ** (-60 / 20)
    silence_ratio = float(np.mean(np.abs(audio) < silence_threshold)) if audio.size else 1.0
    score = rms * (1.0 - silence_ratio)
    if peak > 0.99:
        score *= 0.5
    if crest > 12.0:
        score *= 0.8
    return {"peak": peak, "rms": rms, "crest": crest, "silence_ratio": silence_ratio,
            "score": score}


def normalize_peak(audio: np.ndarray, peak_db: float = -1.0) -> np.ndarray:
    """Peak-normalize to peak_db dBFS."""
    target = 10 ** (peak_db / 20)
    peak = np.abs(audio).max()
    if peak > 0:
        audio = audio * (target / peak)
    return audio.astype(np.float32)


def cmd_prepare(args):
    in_dir = Path(args.input_dir)
    wavs = sorted(in_dir.glob("*.wav"))
    if not wavs:
        print(f"no wav files under {in_dir}", file=sys.stderr)
        return 1
    scored = []
    for p in wavs:
        audio, _ = load_wav(str(p), target_sr=args.sample_rate)
        scored.append((quality_score(audio, args.sample_rate), p, audio))
    scored.sort(key=lambda t: -t[0]["score"])

    picked, total = [], 0.0
    fade = int(args.sample_rate * args.fade_ms / 1000)
    for q, p, audio in scored:
        if total >= args.target_duration:
            break
        picked.append((p, audio, q))
        total += len(audio) / args.sample_rate

    pieces = []
    for _, audio, _ in picked:
        a = audio.copy()
        if fade and len(a) > 2 * fade:
            ramp = np.linspace(0.0, 1.0, fade, dtype=np.float32)
            a[:fade] *= ramp
            a[-fade:] *= ramp[::-1]
        pieces.append(a)
    combined = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    limit = int(args.target_duration * args.sample_rate)
    combined = normalize_peak(combined[:limit], args.peak_db)
    save_wav(args.output, combined, args.sample_rate)
    report = {
        "output": args.output,
        "duration_s": round(len(combined) / args.sample_rate, 2),
        "clips": [{"path": str(p), **{k: round(v, 4) for k, v in q.items()}}
                  for p, _, q in picked],
    }
    print(json.dumps(report, indent=2))
    return 0


def save_speaker(path: str, spk) -> None:
    """A SpeakerConditioning as an .npz under the JAX tool's keys."""
    arrays = {k: getattr(spk, k) for k in KEYS}
    np.savez(path, **{k: v.float().cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v) for k, v in arrays.items()})


def cmd_precompute(args):
    from indextts_tpu_torch.tools import make_engine

    engine = make_engine(args.model_dir, args.device, args.cfg)
    audio, sr = load_wav(args.audio)
    spk = engine.prepare_speaker(audio, sr)
    save_speaker(args.output, spk)
    print(f"wrote {args.output}: cond_len={spk.cond_len} ref_mel_len={spk.ref_mel_len}")
    return 0


def load_precomputed_speaker(path: str, device=None):
    """An .npz written by `precompute` (of either package) as the port's
    SpeakerConditioning, its tensors float32 on `device` (default: the
    card)."""
    from indextts_tpu_torch.runtime.engine import SpeakerConditioning
    from indextts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with np.load(path) as z:
        return SpeakerConditioning(**{
            k: int(z[k]) if k in ("cond_len", "ref_mel_len")
            else torch.as_tensor(np.asarray(z[k], np.float32), device=dev) for k in KEYS})


def main(argv=None):
    p = argparse.ArgumentParser(prog="voice_conditioning")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prepare", help="select + concatenate prompt clips")
    pp.add_argument("--input-dir", required=True)
    pp.add_argument("--output", required=True)
    pp.add_argument("--target-duration", type=float, default=12.0)
    pp.add_argument("--sample-rate", type=int, default=16000)
    pp.add_argument("--fade-ms", type=float, default=10.0)
    pp.add_argument("--peak-db", type=float, default=-1.0)
    pp.set_defaults(fn=cmd_prepare)

    pc = sub.add_parser("precompute", help="precompute speaker conditioning")
    pc.add_argument("--audio", required=True)
    pc.add_argument("--output", required=True)
    pc.add_argument("--model-dir", default=None)
    pc.add_argument("--cfg", default=None)
    pc.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    pc.set_defaults(fn=cmd_precompute)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

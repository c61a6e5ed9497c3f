#!/usr/bin/env python
"""Quality-evaluation harness on the port: zero-shot WER, speaker
similarity, emotion fidelity.

Counterpart of tools/eval_quality.py, with its flags (plus --device), its
scoring and its artifact:

  - **WER** (zero-shot intelligibility): synthesize each case, transcribe
    with a pluggable ASR backend, score mixed zh/en token error rate
    (CJK chars as tokens, latin words as tokens — standard mixed WER/CER).
    Backends: ``mock`` (echoes the reference text, optionally corrupted —
    proves the harness without an ASR model), ``hf:<model-path>`` (any local
    transformers ASR pipeline, e.g. whisper; needs the transformers
    package), ``cmd:<template>`` (external command with a ``{wav}``
    placeholder printing the transcript).
  - **Speaker similarity**: cosine between the CAMPPlus style embedding of
    the prompt audio and of the synthesized audio — the embedding the
    engine computes for the DiT's style conditioning (prepare_speaker).
  - **Emotion fidelity**: cosine between the GPT emotion-perceiver vector
    (UnifiedVoice.get_emovec) of the synthesized audio and the target
    emotion vector — the emo reference audio's emovec, the emotion-matrix
    blend for emo_vector cases, or the speaker prompt's emovec when no
    emotion control is requested.

Cases are JSONL rows (examples/cases.jsonl): ``id``, ``text``, and
optionally ``spk_audio``, ``emo_audio``, ``emo_vector``, ``emo_alpha``.

  python -m indextts_tpu_torch.tools.eval_quality --cases examples/cases.jsonl \\
      --spk-audio voice.wav [--model-dir CKPT] [--asr mock] [--device cpu]

Output: one JSON artifact (default EVAL.json) with per-case rows,
aggregates, negative controls and meta. Without --model-dir the engine runs
seeded random weights and the numbers exercise the harness, not the model —
the artifact records which. The engine runs on the card unless --device cpu
is given.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# WER scoring (mixed zh/en)
# ---------------------------------------------------------------------------

_CJK = r"㐀-䶿一-鿿豈-﫿"
_TOKEN_RE = re.compile(rf"[{_CJK}]|[a-z0-9']+")


def tokenize_for_wer(text: str) -> List[str]:
    """Mixed-script scoring units: each CJK char is one token (CER
    semantics), each lowercase latin/digit run is one token (WER
    semantics). Punctuation and whitespace are dropped; width/case are
    normalized so TN artifacts don't count as errors."""
    text = unicodedata.normalize("NFKC", text).lower()
    return _TOKEN_RE.findall(text)


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance over token sequences (S + D + I)."""
    if not ref:
        return len(hyp)
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,            # deletion
                cur[j - 1] + 1,         # insertion
                prev[j - 1] + (r != h), # substitution / match
            )
        prev = cur
    return prev[-1]


def wer_counts(ref_text: str, hyp_text: str) -> Tuple[int, int]:
    """(edit errors, reference token count) — aggregate WER over a corpus is
    sum(errors)/sum(ref_tokens), not a mean of per-case rates."""
    ref = tokenize_for_wer(ref_text)
    hyp = tokenize_for_wer(hyp_text)
    return edit_distance(ref, hyp), len(ref)


# ---------------------------------------------------------------------------
# ASR backends
# ---------------------------------------------------------------------------


class MockASR:
    """Echoes the reference text, optionally corrupted (token drop at
    ``drop`` probability). Proves the harness plumbing and the scoring
    math without an ASR checkpoint; WER is 0 at drop=0 and >0 otherwise,
    by construction."""

    name = "mock"
    needs_ref = True

    def __init__(self, drop: float = 0.0, seed: int = 0):
        self.drop = float(drop)
        self.rng = np.random.default_rng(seed)

    def transcribe(self, wav: np.ndarray, sr: int, ref_text: str = "") -> str:
        if self.drop <= 0:
            return ref_text
        toks = tokenize_for_wer(ref_text)
        kept = [t for t in toks if self.rng.random() >= self.drop]
        return " ".join(kept)


class HFASR:
    """transformers automatic-speech-recognition pipeline over a *local*
    model path (nothing is downloaded). Without the transformers package it
    raises; it never falls back to another backend."""

    needs_ref = False

    def __init__(self, model_path: str):
        try:
            from transformers import pipeline
        except ImportError as e:
            raise ImportError(
                f"--asr hf:{model_path} needs the transformers package, which is not "
                "installed; use --asr mock or --asr cmd:<template>") from e

        self.name = f"hf:{model_path}"
        self.pipe = pipeline("automatic-speech-recognition", model=model_path)

    def transcribe(self, wav: np.ndarray, sr: int, ref_text: str = "") -> str:
        out = self.pipe({"array": np.asarray(wav, np.float32), "sampling_rate": sr})
        return out["text"] if isinstance(out, dict) else str(out)


class CmdASR:
    """External ASR: shell template with a ``{wav}`` placeholder; the
    command must print the transcript on stdout."""

    needs_ref = False

    def __init__(self, template: str):
        self.name = f"cmd:{template}"
        self.template = template

    def transcribe(self, wav: np.ndarray, sr: int, ref_text: str = "") -> str:
        from indextts_tpu_torch.utils.audio import save_wav

        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            save_wav(f.name, np.asarray(wav, np.float32), sr)
            out = subprocess.run(
                self.template.format(wav=f.name),
                shell=True, capture_output=True, text=True, timeout=600,
            )
        return out.stdout.strip()


def make_asr(spec: str, mock_drop: float = 0.0, seed: int = 0):
    if spec == "mock":
        return MockASR(drop=mock_drop, seed=seed)
    if spec.startswith("hf:"):
        return HFASR(spec[3:])
    if spec.startswith("cmd:"):
        return CmdASR(spec[4:])
    raise ValueError(f"unknown ASR backend {spec!r} (mock | hf:<path> | cmd:<tpl>)")


# ---------------------------------------------------------------------------
# Embedding probes (the engine's own conditioning stack)
# ---------------------------------------------------------------------------


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    den = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / den) if den > 0 else 0.0


@torch.inference_mode()
def campplus_style(engine, wav: np.ndarray, sr: int) -> np.ndarray:
    """(1, 192) CAMPPlus speaker embedding of arbitrary audio, by
    prepare_speaker's pipeline: 16 kHz kaldi fbank, mean-norm, CAMPPlus."""
    from indextts_tpu_torch.frontend import features as feat
    from indextts_tpu_torch.utils import audio as audio_utils

    wav16 = audio_utils.resample(np.asarray(wav, np.float32), sr, 16000)
    fb = feat.campplus_fbank(wav16)
    fb = fb - fb.mean(axis=0, keepdims=True)
    return engine.campplus(engine._tensor(fb[None], torch.float32)).float().cpu().numpy()


@torch.inference_mode()
def emovec_of(engine, wav: np.ndarray, sr: int) -> np.ndarray:
    """(1, model_dim) emotion vector of arbitrary audio through the GPT's
    emotion conditioning path (w2v-BERT, normalized by the semantic stats,
    then the emo conformer, perceiver and emovec layers:
    UnifiedVoice.get_emovec)."""
    from indextts_tpu_torch.utils import audio as audio_utils

    wav16 = audio_utils.resample(np.asarray(wav, np.float32), sr, 16000)
    cond, n = engine._w2v(wav16)
    return engine.gpt.get_emovec(cond, engine._tensor([n])).float().cpu().numpy()


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


def _synthesize(engine, case: Dict, spk: str, seed: int,
                gen_kwargs: Optional[Dict] = None) -> Dict:
    kwargs = dict(gen_kwargs or {})
    if case.get("emo_audio"):
        kwargs["emo_audio"] = case["emo_audio"]
    if case.get("emo_alpha") is not None:
        kwargs["emo_alpha"] = case["emo_alpha"]
    if case.get("emo_vector"):
        kwargs["emo_vector"] = engine.normalize_emo_vec(case["emo_vector"])
    text = case["text"]
    if engine.tokenizer is not None:
        return engine.infer_text(spk, text, seed=seed, **kwargs)
    # tokenizer-less engines (random weights, tiny test configs): the shared
    # byte pseudo-tokens (frontend.tokenizer.byte_fallback_ids)
    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids

    ids = byte_fallback_ids(text, engine.cfg.gpt.number_text_tokens)
    return engine.infer(spk, [ids], seed=seed, **kwargs)


def evaluate(
    engine,
    cases: List[Dict],
    asr,
    spk_audio: Optional[str] = None,
    seed: int = 0,
    wav_dir: Optional[str] = None,
    progress: Optional[Callable[[Dict], None]] = None,
    gen_kwargs: Optional[Dict] = None,
    controls: bool = True,
    control_spk_audio: Optional[str] = None,
) -> Dict:
    """Run the three quality metrics over `cases`; returns the artifact
    dict (rows + aggregates). `asr` is any object with
    ``transcribe(wav, sr, ref_text) -> str``; `gen_kwargs` go to every
    infer call (e.g. num_beams=1, do_sample=False for greedy decoding).

    controls=True adds NEGATIVE-CONTROL rows: each synthesized clip is also
    scored against a *wrong* speaker embedding and a *mismatched* emotion
    target. A metric only means something if the same-pair score beats the
    cross-pair score; when it doesn't (e.g. random-weight CAMPPlus
    embeddings saturating near cosine 1.0), the artifact says so in meta
    instead of publishing 1.0 as if measured. control_spk_audio: an
    explicit wrong-speaker prompt; default is another distinct prompt
    among the cases, falling back to a synthetic noise prompt (flagged)
    when every case shares one prompt."""
    from indextts_tpu_torch.utils import audio as audio_utils

    rows = []
    probes = []  # (synth_style, synth_emovec, target_emo, prompt_key)
    tot_err = tot_ref = 0
    spk_sims, emo_sims = [], []
    # per-prompt caches: a shared --spk-audio prompt would otherwise
    # recompute its CAMPPlus style (and its neutral-mode emovec, a whole
    # w2v-BERT forward) once per case; each is a constant of the prompt path
    prompt_cache: Dict[str, tuple] = {}
    prompt_emo_cache: Dict[str, np.ndarray] = {}
    for i, case in enumerate(cases):
        spk = case.get("spk_audio") or spk_audio
        if spk is None:
            raise ValueError("need spk_audio (per case or default)")
        # gen_time_s rows are only comparable within the same cache state:
        # this row's speaker conditioning was already warm iff the prompt was
        # seen earlier in this run; first captures of a shape add further
        # cost, and run_index orders them
        cached = isinstance(spk, str) and spk in prompt_cache
        t0 = time.perf_counter()
        out = _synthesize(engine, case, spk, seed + i, gen_kwargs)
        gen_s = time.perf_counter() - t0
        wav, out_sr = np.asarray(out["audio"], np.float32), out["sampling_rate"]
        if wav_dir:
            Path(wav_dir).mkdir(parents=True, exist_ok=True)
            audio_utils.save_wav(str(Path(wav_dir) / f"{case.get('id', i)}.wav"), wav, out_sr)

        hyp = asr.transcribe(wav, out_sr, ref_text=case["text"])
        err, n_ref = wer_counts(case["text"], hyp)
        tot_err += err
        tot_ref += n_ref

        cache_key = spk if isinstance(spk, str) else None
        if cache_key is not None and cache_key in prompt_cache:
            prompt_wav, prompt_sr, prompt_style = prompt_cache[cache_key]
        else:
            prompt_wav, prompt_sr = audio_utils.load_wav(spk) if isinstance(spk, str) else spk
            prompt_style = campplus_style(engine, prompt_wav, prompt_sr)
            if cache_key is not None:
                prompt_cache[cache_key] = (prompt_wav, prompt_sr, prompt_style)
        synth_style = campplus_style(engine, wav, out_sr)
        s_sim = cosine(prompt_style, synth_style)
        spk_sims.append(s_sim)

        if case.get("emo_audio"):
            ew, esr = audio_utils.load_wav(case["emo_audio"])
            target_emo = emovec_of(engine, ew, esr)
            emo_mode = "audio"
        elif case.get("emo_vector"):
            target_emo = engine._emovec_from_matrix(
                engine.normalize_emo_vec(case["emo_vector"]),
                engine._tensor(prompt_style), use_random=False,
            ).float().cpu().numpy()
            emo_mode = "vector"
        else:
            if cache_key is not None and cache_key in prompt_emo_cache:
                target_emo = prompt_emo_cache[cache_key]
            else:
                target_emo = emovec_of(engine, prompt_wav, prompt_sr)
                if cache_key is not None:
                    prompt_emo_cache[cache_key] = target_emo
            emo_mode = "neutral"
        synth_emovec = emovec_of(engine, wav, out_sr)
        e_sim = cosine(synth_emovec, target_emo)
        emo_sims.append(e_sim)
        probes.append((synth_style, synth_emovec, np.asarray(target_emo), cache_key))

        row = {
            "id": case.get("id", str(i)),
            "wer": round(err / max(n_ref, 1), 4),
            "wer_errors": err,
            "ref_tokens": n_ref,
            "spk_sim": round(s_sim, 4),
            "emo_sim": round(e_sim, 4),
            "emo_mode": emo_mode,
            "audio_dur_s": round(out["duration_sec"], 3),
            "gen_time_s": round(gen_s, 3),
            "cached": cached,
            "run_index": i,
        }
        rows.append(row)
        if progress:
            progress(row)

    result = {
        "meta": {
            "asr": asr.name,
            "asr_needs_ref": bool(getattr(asr, "needs_ref", False)),
            "n_cases": len(cases),
            "seed": seed,
            "timing_note": (
                "gen_time_s rows mix cache states: cached=false rows pay "
                "conditioning extraction, and early run_index rows pay "
                "first-shape CUDA graph captures — compare like with like"
            ),
        },
        "cases": rows,
        "aggregate": {
            "wer": round(tot_err / max(tot_ref, 1), 4),
            "spk_sim_mean": round(float(np.mean(spk_sims)), 4),
            "spk_sim_min": round(float(np.min(spk_sims)), 4),
            "emo_sim_mean": round(float(np.mean(emo_sims)), 4),
        },
    }
    if controls and rows:
        result["controls"] = _negative_controls(
            engine, rows, probes, prompt_cache, control_spk_audio)
        _flag_degenerate_metrics(result)
    return result


def _negative_controls(engine, rows, probes, prompt_cache, control_spk_audio):
    """Wrong-speaker / mismatched-emotion control scores. Each synthesized
    clip's embedding is re-scored against a DIFFERENT prompt's speaker
    style and a DIFFERENT row's emotion target; `margin = same - cross` per
    row. Positive margins demonstrate the metric separates; ~zero margins
    mean it measured nothing on these weights (then meta says so)."""
    from indextts_tpu_torch.utils import audio as audio_utils

    # wrong-speaker styles: an explicit control prompt, else every distinct
    # case prompt, else a synthetic deterministic noise prompt (flagged)
    cross_styles: Dict[str, np.ndarray] = {}
    synthetic = False
    if control_spk_audio:
        w, sr = audio_utils.load_wav(control_spk_audio)
        cross_styles[control_spk_audio] = campplus_style(engine, w, sr)
    else:
        for key, (_, _, style) in prompt_cache.items():
            cross_styles[key] = style
        if len(cross_styles) < 2:
            rng = np.random.default_rng(1234)
            noise = (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32)
            cross_styles["synthetic:noise"] = campplus_style(engine, noise, 16000)
            synthetic = True

    spk_rows, emo_rows = [], []
    n = len(rows)
    for i, (row, (style, emovec, target, key)) in enumerate(zip(rows, probes)):
        # a cross style from a different prompt than this row's
        cross_key = next((k for k in cross_styles if k != key), next(iter(cross_styles)))
        cross = cosine(style, cross_styles[cross_key])
        spk_rows.append({
            "id": row["id"], "same": row["spk_sim"],
            "cross": round(cross, 4),
            "margin": round(row["spk_sim"] - cross, 4),
            "cross_prompt": cross_key,
        })
        # mismatched emotion target: the nearest other row with a target
        # that actually differs from this row's
        cross_e = None
        for j in range(1, n):
            other = probes[(i + j) % n][2]
            if other.shape == target.shape and not np.allclose(other, target):
                cross_e = cosine(emovec, other)
                break
        if cross_e is not None:
            emo_rows.append({
                "id": row["id"], "same": row["emo_sim"],
                "cross": round(cross_e, 4),
                "margin": round(row["emo_sim"] - cross_e, 4),
            })

    out = {
        "spk": spk_rows,
        "spk_margin_mean": round(float(np.mean([r["margin"] for r in spk_rows])), 4),
        "spk_control_synthetic": synthetic,
    }
    if emo_rows:
        out["emo"] = emo_rows
        out["emo_margin_mean"] = round(float(np.mean([r["margin"] for r in emo_rows])), 4)
    else:
        out["emo_note"] = (
            "all cases share one emotion target; no mismatched-emotion "
            "control is constructible from this case set"
        )
    return out


def _flag_degenerate_metrics(result, min_margin: float = 0.01):
    """If the same-pair score does not beat the cross-pair score, the
    metric separated nothing on these weights — record that in meta instead
    of letting a 1.0000 read as a measurement."""
    c = result.get("controls", {})
    meta = result["meta"]
    spk_m = c.get("spk_margin_mean")
    if spk_m is not None:
        meta["spk_sim_discriminative"] = bool(spk_m >= min_margin)
        if spk_m < min_margin:
            meta["spk_sim_note"] = (
                f"spk_sim margin over wrong-speaker control is {spk_m} "
                "(<" f"{min_margin}): the embedding does not separate "
                "speakers on these weights — spk_sim values above measured "
                "nothing (random-weight CAMPPlus saturates near cosine 1.0)"
            )
    emo_m = c.get("emo_margin_mean")
    if emo_m is not None:
        meta["emo_sim_discriminative"] = bool(emo_m >= min_margin)
        if emo_m < min_margin:
            meta["emo_sim_note"] = (
                f"emo_sim margin over mismatched-target control is {emo_m}: "
                "the emotion probe does not separate targets on these weights"
            )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cases", required=True, help="JSONL case file")
    p.add_argument("--model-dir", default=None,
                   help="checkpoint dir (omit: random weights, harness-only run)")
    p.add_argument("--spk-audio", default=None, help="default prompt wav")
    p.add_argument("--asr", default="mock",
                   help="ASR backend: mock | hf:<model-path> | cmd:<tpl with {wav}>")
    p.add_argument("--mock-asr-drop", type=float, default=0.0,
                   help="mock backend: per-token corruption probability")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="EVAL.json")
    p.add_argument("--wav-dir", default=None, help="save synthesized wavs here")
    p.add_argument("--control-spk-audio", default=None,
                   help="wrong-speaker prompt for the negative control "
                        "(default: another distinct case prompt, else a "
                        "flagged synthetic noise prompt)")
    p.add_argument("--no-controls", action="store_true",
                   help="skip the negative-control section")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from indextts_tpu_torch.tools import make_engine

    engine = make_engine(args.model_dir, args.device)
    weights = "checkpoint" if args.model_dir else "random"
    cases = [json.loads(line) for line in open(args.cases) if line.strip()]
    asr = make_asr(args.asr, mock_drop=args.mock_asr_drop, seed=args.seed)
    result = evaluate(
        engine, cases, asr, spk_audio=args.spk_audio, seed=args.seed,
        wav_dir=args.wav_dir,
        progress=lambda r: print(json.dumps(r), file=sys.stderr),
        controls=not args.no_controls,
        control_spk_audio=args.control_spk_audio,
    )
    meta = result["meta"]
    meta["weights"] = weights
    meta["model_dir"] = args.model_dir
    if weights == "random":
        meta["note"] = "random weights: numbers validate the harness, not the model"
    meta["device"] = str(engine.device)
    meta["max_mel_tokens"] = engine.cfg.runtime.max_mel_tokens
    Path(args.output).write_text(json.dumps(result, indent=2) + "\n")
    print(json.dumps({"output": args.output, **result["aggregate"]}))
    return result


if __name__ == "__main__":
    main()

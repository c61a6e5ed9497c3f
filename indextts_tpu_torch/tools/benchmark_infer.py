#!/usr/bin/env python
"""Case-driven inference benchmark on the port (reference:
tests/benchmark_infer_v2.py).

  python -m indextts_tpu_torch.tools.benchmark_infer --cases cases.jsonl \
      --spk-audio voice.wav [--model-dir checkpoints] [--output result.json] [--device cpu]

Counterpart of tools/benchmark_infer.py, with its flags (plus --device) and
its artifact: reads a JSONL case file (fields: text, and optionally
spk_audio, emo_mode, emo_audio, emo_vector, emo_alpha, infer_mode — the
reference's tests/cases.jsonl + examples/cases.jsonl schema), synthesizes
each case, and reports per-case GenTime / AudioDur / RTF / peak device
memory plus aggregates as JSON. The engine comes from --model-dir
(runtime/loader.py `load_engine`), else the default configuration with
seeded random weights; it runs on the card unless --device cpu is given.
`hbm_peak_gb` keeps the JAX name: the CUDA caching allocator's peak bytes
allocated (utils/obs.py `get_hbm_usage`), 0 on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m indextts_tpu_torch.tools.benchmark_infer")
    p.add_argument("--cases", required=True, help="JSONL case file")
    p.add_argument("--model-dir", default=None)
    p.add_argument("--spk-audio", default=None, help="default prompt wav")
    p.add_argument("--output", default=None, help="result JSON path")
    p.add_argument("--wav-dir", default=None, help="save per-case wavs here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.tools import make_engine
    from indextts_tpu_torch.utils.audio import save_wav
    from indextts_tpu_torch.utils.obs import get_hbm_usage

    engine = make_engine(args.model_dir, device=args.device)

    cases = [json.loads(line) for line in open(args.cases) if line.strip()]
    results = []
    for i, case in enumerate(cases):
        text = case["text"]
        spk = case.get("spk_audio") or args.spk_audio
        if spk is None:
            raise SystemExit("need --spk-audio or per-case spk_audio")
        kwargs = {}
        if case.get("emo_audio"):
            kwargs["emo_audio"] = case["emo_audio"]
        if case.get("emo_alpha") is not None:
            kwargs["emo_alpha"] = case["emo_alpha"]
        if case.get("emo_vector"):
            kwargs["emo_vector"] = engine.normalize_emo_vec(case["emo_vector"])

        t0 = time.perf_counter()
        if engine.tokenizer is not None:
            out = engine.infer_text(spk, text, seed=args.seed + i, **kwargs)
        else:
            ids = byte_fallback_ids(text, engine.cfg.gpt.number_text_tokens)
            out = engine.infer(spk, [ids], seed=args.seed + i, **kwargs)
        gen_time = time.perf_counter() - t0
        hbm = get_hbm_usage(engine.device)
        row = {
            "case": i,
            "text_len": len(text),
            "gen_time_s": round(gen_time, 3),
            "audio_dur_s": round(out["duration_sec"], 3),
            "rtf": round(gen_time / max(out["duration_sec"], 1e-9), 4),
            "hbm_peak_gb": round(hbm.get("peak_gb_in_use", 0), 2),
        }
        results.append(row)
        print(json.dumps(row), file=sys.stderr)
        if args.wav_dir:
            Path(args.wav_dir).mkdir(parents=True, exist_ok=True)
            save_wav(str(Path(args.wav_dir) / f"case_{i:03d}.wav"), out["audio"],
                     out["sampling_rate"])

    total_gen = sum(r["gen_time_s"] for r in results)
    total_audio = sum(r["audio_dur_s"] for r in results)
    summary = {
        "cases": len(results),
        "total_gen_time_s": round(total_gen, 2),
        "total_audio_s": round(total_audio, 2),
        "rtf": round(total_gen / max(total_audio, 1e-9), 4),
        "audio_sec_per_s": round(total_audio / max(total_gen, 1e-9), 3),
        "results": results,
    }
    print(json.dumps(summary))
    if args.output:
        Path(args.output).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()

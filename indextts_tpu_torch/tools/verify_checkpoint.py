"""Checkpoint self-test on the port: validate a reference checkpoint
directory against the port's converters before committing to a deployment.

Counterpart of tools/verify_checkpoint.py, with its flags, report and exit
code:

  1. inventories which checkpoint files are present/missing
     (gpt.pth, s2mel.pth, wav2vec2bert_stats.pt, feat1/feat2.pt, bpe.model,
     hf/{w2v-bert-2.0, semantic_codec.safetensors, campplus_cn_common.bin,
     bigvgan_generator.pt}),
  2. converts them (runtime/loader.py `convert_reference_checkpoints`, the
     GPT's text_head kept, as the JAX converter keeps it) and diffs each
     state dict against the port's `random_params` (the schema oracle):
     names and shapes of the floating-point tensors, the weights and
     statistics that the JAX trees hold (BatchNorm's integer
     `num_batches_tracked` counters are not weights),
  3. checks the emo/spk matrix layout (feat2.pt rows == sum(config
     emo_num), reference infer_v2.py:281-289) and the semantic stats,
  4. with --synth, runs a one-segment synthesis through `load_engine` and
     reports its time and output stats.

It runs on the card unless --device cpu is given. Exit code 0 = everything
present and structurally sound; 1 = problems (missing files are warnings
unless --strict).

  python -m indextts_tpu_torch.tools.verify_checkpoint --model-dir checkpoints --synth
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

EXPECTED_FILES = [
    "config.yaml", "gpt.pth", "s2mel.pth", "wav2vec2bert_stats.pt",
    "feat1.pt", "feat2.pt", "bpe.model", "hf/w2v-bert-2.0",
    "hf/semantic_codec.safetensors", "hf/campplus_cn_common.bin",
    "hf/bigvgan_generator.pt",
]


def schema(state_dict) -> dict:
    """{name: shape} of a state dict's floating-point tensors."""
    return {k: tuple(v.shape) for k, v in state_dict.items() if v.is_floating_point()}


def diff_schema(want, got):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mismatched = sorted(p for p in set(want) & set(got) if want[p] != got[p])
    return missing, extra, mismatched


def synth_smoke(model_dir: str, cfg, device, spk_audio) -> dict:
    """One segment through the engine `load_engine` builds: "Checkpoint self
    test." through the tokenizer, or ids 2..9 without one."""
    from indextts_tpu_torch.runtime.loader import load_engine
    from indextts_tpu_torch.utils.audio import load_wav

    engine = load_engine(model_dir, cfg=cfg, device=device)
    if spk_audio:
        wav, sr = load_wav(spk_audio)
    else:
        sr = 16000
        wav = (np.random.default_rng(0).standard_normal(3 * sr) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    if engine.tokenizer is not None:
        out = engine.infer_text((wav, sr), "Checkpoint self test.", seed=0)
    else:
        out = engine.infer((wav, sr), [np.arange(2, 10, dtype=np.int32)], seed=0)
    audio = np.asarray(out["audio"])
    return {"wall_s": round(time.perf_counter() - t0, 2),
            "audio_s": round(out["duration_sec"], 3),
            "finite": bool(np.isfinite(audio).all()),
            "peak": round(float(np.abs(audio).max()), 4)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--synth", action="store_true",
                    help="also run a one-segment synthesis smoke")
    ap.add_argument("--spk-audio", default=None,
                    help="prompt wav for --synth (default: synthetic noise)")
    ap.add_argument("--strict", action="store_true",
                    help="missing checkpoint files are errors, not warnings")
    ap.add_argument("--output", default=None, help="write report JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from indextts_tpu_torch.runtime.engine import random_params
    from indextts_tpu_torch.runtime.loader import convert_reference_checkpoints, model_config
    from indextts_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    d = Path(args.model_dir)
    report = {"model_dir": str(d), "files": {}, "components": {}, "ok": True}

    for rel in EXPECTED_FILES:
        present = (d / rel).exists()
        report["files"][rel] = "present" if present else "MISSING"
        if not present and args.strict:
            report["ok"] = False

    cfg = model_config(str(d))
    params, aux = convert_reference_checkpoints(str(d), cfg, text_head=True)
    oracle = random_params(cfg, seed=0, device=device)

    for name, oracle_sd in oracle.items():
        if name not in params:
            report["components"][name] = {"status": "not in checkpoint dir"}
            if args.strict:
                report["ok"] = False
            continue
        want, got = schema(oracle_sd), schema(params[name])
        missing, extra, mism = diff_schema(want, got)
        # extra names are informational only: the converter can carry heads
        # the inference oracle never builds (the GPT's text_head)
        comp = {"status": "ok" if not (missing or mism) else "SCHEMA DIFF",
                "leaves": len(got),
                "params": sum(int(np.prod(s)) if s else 1 for s in got.values())}
        if missing:
            comp["missing_paths"] = missing[:20]
        if extra:
            comp["extra_paths_info"] = extra[:20]
        if mism:
            comp["shape_mismatches"] = [f"{p}: want {want[p]} got {got[p]}" for p in mism[:20]]
        if comp["status"] != "ok":
            report["ok"] = False
        report["components"][name] = comp
    del oracle

    n_expected = sum(cfg.emo_num)
    for key, dim in (("emo_matrix", cfg.gpt.model_dim), ("spk_matrix", 192)):
        if key in aux:
            shape = tuple(aux[key].shape)
            ok = shape[0] == n_expected and shape[1] == dim
            report["components"][key] = {"status": "ok" if ok else "LAYOUT MISMATCH",
                                         "shape": shape, "expected": (n_expected, dim)}
            if not ok:
                report["ok"] = False
    if "semantic_stats" in aux:
        m, s = aux["semantic_stats"]
        report["components"]["semantic_stats"] = {
            "status": "ok" if m.shape == s.shape == (cfg.w2vbert.hidden_size,)
            else "SHAPE MISMATCH",
            "mean_shape": tuple(m.shape), "std_shape": tuple(s.shape)}

    if args.synth:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        report["synth"] = synth_smoke(str(d), cfg, device, args.spk_audio)
        if not report["synth"]["finite"]:
            report["ok"] = False

    text = json.dumps(report, indent=2)
    print(text)
    if args.output:
        Path(args.output).write_text(text + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

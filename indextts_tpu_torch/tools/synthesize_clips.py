"""Voice-clip corpus tools on the port: phrase-bank JSONL generation and
batch synthesis against one reference voice.

Counterpart of tools/synthesize_clips.py, with its subcommands, flags and
outputs:

  # 1. write a synthesis input file from the built-in phrase bank
  python -m indextts_tpu_torch.tools.synthesize_clips make-input \\
      --output data/input.jsonl --count 20 [--shuffle --seed 7] [--phrases my_phrases.txt]

  # 2. synthesize every {id, text} row against one reference voice
  python -m indextts_tpu_torch.tools.synthesize_clips synth --input data/input.jsonl \\
      --reference voice.wav --output-dir data/clips [--model-dir CKPT] \\
      [--batched] [--max-samples N] [--device cpu]

`--batched` sends each clip's segments through one batched decode and one
batched s2mel and vocoder call (`IndexTTS2Engine.infer(batched=True)`).
`synth` writes <id>.wav files and a manifest.json summary; a clip that
fails is recorded with its error and the others go on. It runs on the card
unless --device cpu is given.

The phrase bank is the JAX tool's: statements, questions, numbers, units
and dates, imperatives, technical vocabulary and long forms.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

PHRASE_BANK = [
    # identity / status statements (declarative prosody)
    "Diagnostics complete. All subsystems report nominal operation.",
    "My reliability estimate for this maneuver is eighty-seven percent.",
    "Candor setting is at ninety percent and holding.",
    "I log every decision I make, in case you want to audit me later.",
    "Running on auxiliary power. Main reactor output is stable.",
    # numbers, units, dates (text-normalization stress)
    "The outer hull is rated for temperatures between minus one hundred and twenty and plus sixty degrees.",
    "Rendezvous is scheduled for 06:45 on March 3rd, 2041.",
    "Fuel margin is 12.5 percent, roughly 340 kilograms.",
    "We have travelled 4,218,000 kilometres since the last course correction.",
    "Signal delay to ground control is now 11 minutes and 20 seconds.",
    # questions (rising prosody)
    "Would you like the long version or the short version?",
    "Shall I reroute power from the habitation ring?",
    "Do you want me to repeat the last telemetry summary?",
    "Is this a good moment to mention the coolant leak?",
    "Which docking port should I target, alpha or bravo?",
    # imperatives / confirmations (short, clipped)
    "Hold position.",
    "Confirmed. Executing.",
    "Negative. Abort the sequence.",
    "Stand by for burn in five, four, three, two, one.",
    "Copy that. Rerouting now.",
    # technical vocabulary (consonant clusters, fricatives)
    "Spectrometer readings show elevated methane concentrations near the southern fissure.",
    "The gyroscope precession exceeds the threshold specified in the flight manual.",
    "Electrolysis throughput depends on the purity of the recovered ice.",
    "Thrust-vector actuators six and seven exhibit asymmetric response curves.",
    "Cryogenic boil-off remains within acceptable daily limits.",
    # conversational / wit (varied rhythm)
    "I would raise an eyebrow here, if I had one.",
    "Technically that was my third-best landing.",
    "You asked for honesty. You did not specify tact.",
    "I have prepared fourteen contingency plans. You will like none of them.",
    "Sarcasm module is optional. Most crews disable it on day two.",
    # long-form (segmentation exercise)
    "Before we commit to the transfer window, consider that the return trajectory "
    "requires a gravity assist, a mid-course correction, and roughly nine months "
    "of patience, none of which are in short supply except the last.",
    "The storm on the horizon is moving faster than the forecast model predicted, "
    "so I recommend securing the solar array, sealing the external hatches, and "
    "postponing the survey until visibility improves.",
]


def _slug(text: str, n: int = 40) -> str:
    s = "".join(c if c.isalnum() else "_" for c in text[:n].lower())
    return "_".join(filter(None, s.split("_")))


def make_input(args) -> int:
    phrases = list(PHRASE_BANK)
    if args.phrases:
        phrases = [line.strip() for line in Path(args.phrases).read_text().splitlines()
                   if line.strip()]
    if args.shuffle:
        random.Random(args.seed).shuffle(phrases)
    phrases = phrases[: args.count]
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for i, text in enumerate(phrases, 1):
            f.write(json.dumps({"id": f"clip_{i:03d}_{_slug(text)}", "text": text}) + "\n")
    print(f"wrote {len(phrases)} phrases -> {out}")
    return 0


def synth(args) -> int:
    inp = Path(args.input)
    if not inp.exists():
        print(f"ERROR: input JSONL not found: {inp}", file=sys.stderr)
        return 1
    ref = Path(args.reference)
    if not ref.exists():
        print(f"ERROR: reference audio not found: {ref}", file=sys.stderr)
        return 1
    with open(inp) as f:
        prompts = [json.loads(line) for line in f if line.strip()]
    if args.max_samples:
        prompts = prompts[: args.max_samples]
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids
    from indextts_tpu_torch.tools import make_engine
    from indextts_tpu_torch.utils.audio import load_wav, save_wav

    engine = make_engine(args.model_dir, args.device)
    spk = load_wav(str(ref))
    manifest, total_audio = [], 0.0
    t_start = time.time()
    for idx, prompt in enumerate(prompts, 1):
        sample_id, text = prompt["id"], prompt["text"]
        wav_path = out_dir / f"{sample_id}.wav"
        print(f"[{idx}/{len(prompts)}] {text[:50]}...")
        t0 = time.time()
        try:
            if engine.tokenizer is not None:
                out = engine.infer_text(spk, text, seed=args.seed + idx, batched=args.batched)
            else:  # random weights: bytes -> token ids
                ids = byte_fallback_ids(text, engine.cfg.gpt.number_text_tokens)
                out = engine.infer(spk, [ids], seed=args.seed + idx, batched=args.batched)
            gen_s = time.time() - t0
            save_wav(str(wav_path), out["audio"], out["sampling_rate"])
            dur = float(out["duration_sec"])
            total_audio += dur
            manifest.append({"id": sample_id, "text": text, "path": wav_path.name,
                             "duration": dur, "generation_time": gen_s})
            print(f"   -> {wav_path.name} ({dur:.2f}s, gen {gen_s:.1f}s)")
        except Exception as e:  # keep going; record the failure
            print(f"   -> ERROR: {e}", file=sys.stderr)
            manifest.append({"id": sample_id, "text": text, "error": str(e)})
    elapsed = time.time() - t_start

    ok = [m for m in manifest if "path" in m]
    summary = {"reference_audio": str(ref), "total_clips": len(ok),
               "total_duration": total_audio, "total_generation_time": elapsed,
               "clips": manifest}
    with open(out_dir / "manifest.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(f"done: {len(ok)}/{len(prompts)} clips, {total_audio:.1f}s audio in {elapsed:.1f}s"
          + (f" (RTF {elapsed / total_audio:.2f})" if total_audio else ""))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="synthesize_clips")
    sub = p.add_subparsers(dest="cmd", required=True)

    mi = sub.add_parser("make-input", help="write a phrase-bank JSONL")
    mi.add_argument("--output", "-o", default="data/synthesis_input.jsonl")
    mi.add_argument("--count", "-n", type=int, default=20)
    mi.add_argument("--shuffle", action="store_true")
    mi.add_argument("--seed", type=int, default=None)
    mi.add_argument("--phrases", default=None, help="text file, one phrase per line")
    mi.set_defaults(fn=make_input)

    sy = sub.add_parser("synth", help="batch-synthesize clips from a JSONL")
    sy.add_argument("--input", "-i", required=True)
    sy.add_argument("--reference", "-r", required=True)
    sy.add_argument("--output-dir", "-o", default="data/clips")
    sy.add_argument("--model-dir", default=None)
    sy.add_argument("--max-samples", type=int, default=None)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--batched", action="store_true",
                    help="pack each clip's segments through one batched decode")
    sy.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    sy.set_defaults(fn=synth)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

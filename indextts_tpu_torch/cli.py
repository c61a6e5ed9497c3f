"""Command-line synthesis with the PyTorch port (after indextts_tpu/cli.py).

  python -m indextts_tpu_torch.cli "text to speak" -v voice.wav -o out.wav \\
      [--model-dir checkpoints] [--emo-audio emo.wav] [--emo-alpha 0.8] \\
      [--emo-vector 0,0,1,0,0,0,0,0] [--seed 0] [--device cpu]

--model-dir loads a reference-layout checkpoint directory
(runtime/loader.py `load_engine`, with --cfg or its config.yaml); without
one the engine runs seeded random weights (the audio is noise: a smoke
test of the pipeline). --emo-vector's 8 weights (happy, angry, sad,
afraid, disgusted, melancholic, surprised, calm) go through
`normalize_emo_vec` (each emotion's bias, the sum capped at 0.8). With a
tokenizer (the directory's bpe.model) the text goes through `infer_text`;
without one its UTF-8 bytes are the ids. Runs on the card unless --device
says otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None, cfg=None):
    """Parse `argv`, synthesize, write the WAV. `cfg` replaces the
    configuration that --cfg (or the checkpoint directory's config.yaml)
    would give. Returns infer()'s result."""
    p = argparse.ArgumentParser(prog="indextts-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("text", help="text to synthesize")
    p.add_argument("-v", "--voice", required=True, help="speaker prompt wav")
    p.add_argument("-o", "--output", default="gen.wav", help="output wav path")
    p.add_argument("--model-dir", default=None, help="reference-layout checkpoint directory")
    p.add_argument("--cfg", default=None, help="config.yaml path")
    p.add_argument("--emo-audio", default=None)
    p.add_argument("--emo-alpha", type=float, default=1.0)
    p.add_argument("--emo-vector", default=None, help="8 comma-separated floats")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-text-tokens-per-segment", type=int, default=120)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain versions of "
                        "the kernels)")
    args = p.parse_args(argv)

    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params
    from indextts_tpu_torch.runtime.loader import load_engine

    if args.model_dir:
        engine = load_engine(args.model_dir, cfg_path=args.cfg, cfg=cfg, device=args.device)
    else:
        print(">> no --model-dir: random weights (smoke-test mode)", file=sys.stderr)
        cfg = cfg if cfg is not None else load_config(args.cfg)
        engine = IndexTTS2Engine(cfg, random_params(cfg, seed=0, device=args.device),
                                 device=args.device)

    emo_vector = None
    if args.emo_vector:
        emo_vector = engine.normalize_emo_vec([float(x) for x in args.emo_vector.split(",")])

    kwargs = dict(emo_audio=args.emo_audio, emo_alpha=args.emo_alpha, emo_vector=emo_vector,
                  output_path=args.output, seed=args.seed)
    if engine.tokenizer is not None:
        out = engine.infer_text(args.voice, args.text,
                                max_text_tokens_per_segment=args.max_text_tokens_per_segment,
                                **kwargs)
    else:
        # no tokenizer: the text's bytes as a toy id sequence
        ids = np.frombuffer(args.text.encode()[:100], dtype=np.uint8).astype(np.int32)
        ids = ids % max(2, engine.cfg.gpt.number_text_tokens - 2) + 2
        out = engine.infer(args.voice, [ids], **kwargs)
    print(f">> wrote {args.output}: {out['duration_sec']:.2f}s audio, RTF {out['rtf']:.3f}")
    return out


if __name__ == "__main__":
    main()

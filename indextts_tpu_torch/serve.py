"""TTS server entry point for the PyTorch port (reference: serve_tars.py).

  python -m indextts_tpu_torch.serve --model-dir checkpoints --port 8000
  TARS_MAX_CONCURRENCY=8 python -m indextts_tpu_torch.serve ...   # continuous

Follows indextts_tpu/serve.py: build the engine, warm it up once on the
default speaker prompt, then serve the copied `TTSServer` (POST /tts, POST
/tts/stream, GET / /ui /healthz /readyz /metrics). With --model-dir (or
TARS_CHECKPOINT_DIR) the engine comes from a reference-layout checkpoint
directory (runtime/loader.py `load_engine`; its bpe.model tokenizes the
text); without one it runs seeded random weights (--seed) and text goes
through `byte_fallback_ids`.

/tts/stream answers chunked s16le PCM: each segment's waveform, then the
silence after it (`IndexTTS2Engine.infer_generator`, or
`infer_generator_continuous` in continuous mode). TARS_QUICK_STREAMING (0:
off), or the payload's `quick_streaming_tokens`, makes the first segments
small until that many tokens are out, so the first chunk comes sooner.
A request on the default prompt (a file path) takes the keyed route: its
conditioning and the conditioning prefix's KV are computed once and reused.

Serving mode: sequential, or continuous batching, where every request's
segments decode in one shared chunked loop (runtime/batcher.py
`ContinuousService`), as the JAX server picks it (`pick_continuous_slots`).
--num-beams (TARS_NUM_BEAMS, default 1) picks the sequential route's
decode, as in the JAX server: 1 samples, 3 runs the reference's
beam-multinomial search (`GPTDecoder.generate_beam`); the background
precompile warms that route's step. Continuous batching always samples.

With a default prompt, a background thread captures the serving
envelope's programs (`IndexTTS2Engine.precompile`: decode steps, latent
passes, s2mel solves and vocoder calls, each a CUDA graph per bucket on the
card) while the warmup synthesis runs, as the JAX server compiles its
programs; requests that come meanwhile capture their own shapes as they
would have anyway. A precompile that fails is printed and serving goes on.

Emotion controls go route by route as in the JAX server (indextts_tpu/
serve.py:109-141, 211-279): `emo_vector` on every route; `use_emo_text`
asks the engine's attached text-to-emotion model (`engine.qwen_emo`, a
runtime/qwen_emo.py QwenEmotion) for the vector, and without one the
request is refused (ValueError, HTTP 400). On the sequential route with a
tokenizer, /tts goes through `infer_text`, which scales the vector by
emo_alpha; the other routes pass alpha on, and the engine drops it (a
vector sets it to 1). With --model-dir, the Qwen of its
qwen0.6bemo4-merge/ is attached when that directory is there
(`build_qwen_emotion`, which needs `transformers`); a Qwen that fails to
load is reported and the server serves without it, as the JAX server does.

Left out against the JAX entry point: the compile cache and multihost
initialization. A warmup that fails raises.

Env knobs keep the TARS_* names: TARS_MAX_CONCURRENCY, TARS_REFERENCE_AUDIO,
TARS_WARMUP, TARS_DIFFUSION_STEPS, TARS_CFG_RATE, TARS_MAX_MEL_TOKENS, TARS_NUM_BEAMS,
TARS_QUICK_STREAMING, TARS_SEQ_TAIL_OVERLAP (1: on);
TARS_CONTINUOUS_SLOTS (default "auto"), TARS_CONTINUOUS_CHUNK (decode steps
a chunk, 32) and TARS_CONTINUOUS_TAIL_WORKERS (2); TARS_PRECOMPILE (1: on),
TARS_PRECOMPILE_CODES (the envelope's longest segment in codes, 512) and
TARS_PRECOMPILE_WORKERS (4).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, List, Optional

import numpy as np


def fallback_segments(text: str, number_text_tokens: int, per_segment: int,
                      max_text_tokens: int, quick: int = 0) -> List[np.ndarray]:
    """No tokenizer (random-weights mode): bytes -> ids, split to the
    per-segment cap the real tokenizer honors; with quick > 0, segments of
    `quick` ids (never more than the cap) until `quick` ids are out, as
    quick_streaming_tokens (the JAX server's `_fallback_segments`,
    indextts_tpu/serve.py:190-209)."""
    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids

    ids = byte_fallback_ids(text, number_text_tokens, max_bytes=200)
    cap = max(1, min(per_segment, max_text_tokens))
    out, i = [], 0
    while True:
        step = min(quick, cap) if 0 < quick and i < quick else cap
        out.append(np.asarray(ids[i:i + step], np.int32))
        i += step
        if i >= len(ids):
            return out


def pick_continuous_slots(env) -> int:
    """Serving-mode selection, as indextts_tpu/serve.py picks it.

    TARS_CONTINUOUS_SLOTS=auto (the default) picks from the declared
    fan-in: sequential (0 slots) while TARS_MAX_CONCURRENCY <= 3, continuous
    batching with one slot per admitted request (capped at 8) from 4 up. An
    explicit integer keeps the choice manual."""
    raw = env.get("TARS_CONTINUOUS_SLOTS", "auto")
    if raw != "auto":
        return int(raw)
    max_conc = int(env.get("TARS_MAX_CONCURRENCY", "1"))
    return min(max_conc, 8) if max_conc >= 4 else 0


def _speaker(default_prompt: Optional[str], spk_audio):
    """A request's speaker prompt; ValueError (HTTP 400) without one."""
    spk = spk_audio or default_prompt
    if spk is None:
        raise ValueError("no speaker prompt: pass spk_audio or set TARS_REFERENCE_AUDIO")
    return spk


def emo_vector_of(engine, text: str, use_emo_text: bool, emo_text: Optional[str], emo_vector):
    """The request's emotion vector (the JAX server's `_emo_kwargs`): with
    use_emo_text, what the engine's text-to-emotion model reads in
    `emo_text` or else the text; ValueError (HTTP 400) when no model is
    attached."""
    if not use_emo_text:
        return emo_vector
    if engine.qwen_emo is None:
        raise ValueError("use_emo_text requested but no Qwen emotion model is loaded "
                         "(checkpoint dir lacks qwen0.6bemo4-merge)")
    return list(engine.qwen_emo.inference(emo_text if emo_text else text).values())


def _segments(engine, text: str, quick: int = 0) -> List[np.ndarray]:
    """A request's segments of token ids: the engine's tokenizer, or
    `fallback_segments` without one."""
    c = engine.cfg
    if engine.tokenizer is not None:
        return engine.text_segments(text, quick_streaming_tokens=quick)
    return fallback_segments(text, c.gpt.number_text_tokens,
                             c.runtime.max_text_tokens_per_segment, c.gpt.max_text_tokens,
                             quick=quick)


def make_synth(engine, default_prompt: Optional[str], service=None,
               num_beams: Optional[int] = None) -> Callable:
    """The server's synth(text, spk_audio, ...) callable over `engine`,
    through the ContinuousService `service` when there is one; on the
    sequential route with a tokenizer through `infer_text`, as the JAX
    server's synth. The sequential route decodes with `num_beams` (default
    the engine's runtime.num_beams); the continuous one samples.
    ValueError -> HTTP 400 in the server."""
    beams = {} if num_beams is None else {"num_beams": num_beams}

    def synth(text="", spk_audio=None, emo_audio=None, emo_alpha=1.0,
              emo_vector=None, seed=None, use_emo_text=False, emo_text=None,
              **kw):
        spk = _speaker(default_prompt, spk_audio)
        if service is None and engine.tokenizer is not None:
            return engine.infer_text(spk, text, use_emo_text=use_emo_text, emo_text=emo_text,
                                     emo_audio=emo_audio, emo_alpha=emo_alpha,
                                     emo_vector=emo_vector, seed=seed, **beams)
        emo_vector = emo_vector_of(engine, text, use_emo_text, emo_text, emo_vector)
        seg_ids = _segments(engine, text)
        if service is not None:
            return engine.infer_continuous(service, spk, seg_ids, emo_audio=emo_audio,
                                           emo_alpha=emo_alpha, emo_vector=emo_vector,
                                           seed=seed)
        return engine.infer(spk, seg_ids, emo_audio=emo_audio,
                            emo_alpha=emo_alpha, emo_vector=emo_vector, seed=seed, **beams)

    return synth


def make_synth_stream(engine, default_prompt: Optional[str], service=None,
                      num_beams: Optional[int] = None) -> Callable:
    """The server's synth_stream(text, ...) generator over `engine`, the
    counterpart of indextts_tpu/serve.py:240-279: each chunk a segment's
    waveform or the silence after it, through `infer_generator` (with
    `num_beams`, as `make_synth`), or `infer_generator_continuous` when
    there is a ContinuousService. The payload's `quick_streaming_tokens`,
    else TARS_QUICK_STREAMING, sizes the first segments."""
    quick_default = int(os.environ.get("TARS_QUICK_STREAMING", "0"))
    beams = {} if num_beams is None else {"num_beams": num_beams}

    def synth_stream(text="", spk_audio=None, emo_audio=None, emo_alpha=1.0,
                     emo_vector=None, seed=None, use_emo_text=False, emo_text=None,
                     quick_streaming_tokens=None, **kw):
        quick = quick_default if quick_streaming_tokens is None else int(quick_streaming_tokens)
        spk = _speaker(default_prompt, spk_audio)
        emo_vector = emo_vector_of(engine, text, use_emo_text, emo_text, emo_vector)
        seg_ids = _segments(engine, text, quick)
        kwargs = dict(emo_audio=emo_audio, emo_alpha=emo_alpha, emo_vector=emo_vector,
                      seed=seed)
        if service is not None:
            yield from engine.infer_generator_continuous(service, spk, seg_ids, **kwargs)
        else:
            yield from engine.infer_generator(spk, seg_ids, **kwargs, **beams)

    return synth_stream


def precompile_in_background(engine, prompt: str, continuous: bool,
                             num_beams: Optional[int] = None) -> Future:
    """Start the JAX server's background precompile (indextts_tpu/serve.py
    :281-321) on the speaker prompt `prompt`: the envelope of
    TARS_PRECOMPILE_CODES codes in TARS_PRECOMPILE_WORKERS threads; decode
    too, on the route of `num_beams` (default the engine's), unless
    `continuous` (continuous serving decodes in its batcher's own state).
    Returns a future of (jobs, seconds); a failure is printed and set on
    it, and never raised into the server."""
    from indextts_tpu_torch.utils import audio as audio_utils

    done: Future = Future()

    def run():
        t0 = time.perf_counter()
        try:
            spk = engine.prepare_speaker(*audio_utils.load_wav(prompt), cache_key=prompt)
            n = engine.precompile(
                spk, max_code_len=int(os.environ.get("TARS_PRECOMPILE_CODES", "512")),
                workers=int(os.environ.get("TARS_PRECOMPILE_WORKERS", "4")),
                num_beams=num_beams, decode_variants="none" if continuous else "both")
        except Exception as e:  # the server goes on; its shapes capture on demand
            traceback.print_exc()
            print(f">> precompile failed: {e!r}", file=sys.stderr)
            done.set_exception(e)
            return
        seconds = time.perf_counter() - t0
        print(f">> precompiled {n} programs in {seconds:.1f} s", file=sys.stderr)
        done.set_result((n, seconds))

    threading.Thread(target=run, daemon=True, name="tars-precompile").start()
    return done


def load_models(args, cfg=None):
    """The engine of `serve.build`'s arguments: from the checkpoint directory
    --model-dir (runtime/loader.py `load_engine`), else seeded random
    weights (--seed), on --device; `cfg` replaces the configuration that
    --cfg, the directory's config.yaml or the TARS_* env would give.
    runtime.num_beams is --num-beams (1, the sampling route, unless
    TARS_NUM_BEAMS or the flag says otherwise), as the JAX server sets it."""
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params
    from indextts_tpu_torch.runtime.loader import load_engine, model_config

    if cfg is None:
        cfg = model_config(args.model_dir, args.cfg) if args.model_dir else load_config(args.cfg)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                               num_beams=args.num_beams))
    if args.model_dir:
        return load_engine(args.model_dir, cfg=cfg, device=args.device)
    print(">> no --model-dir: random weights (smoke-test mode)", file=sys.stderr)
    # each module's own seeded initialization: the JAX package's
    # all-positive fill overflows the vocoder to NaN at full width
    return IndexTTS2Engine(cfg, random_params(cfg, seed=args.seed, device=args.device),
                           device=args.device)


def attach_qwen(engine, model_dir: str) -> None:
    """Attach the text-to-emotion model of `model_dir`/qwen0.6bemo4-merge
    when the directory ships one (the reference loads it lazily,
    infer_v2.py:321-328); a failure is reported and the engine serves
    without it, as the JAX server does."""
    from pathlib import Path

    from indextts_tpu_torch.utils.obs import print_stage

    qdir = Path(model_dir) / "qwen0.6bemo4-merge"
    if not qdir.is_dir():
        return
    try:
        from indextts_tpu_torch.runtime.qwen_emo import build_qwen_emotion

        engine.qwen_emo = build_qwen_emotion(str(qdir), device=engine.device)
        print_stage("Qwen emotion model attached", "complete")
    except Exception as e:  # degraded mode: use_emo_text answers 400
        traceback.print_exc()
        print_stage("Qwen emotion load failed", "failed", message_extra=repr(e))


def build(argv=None, cfg=None, engine=None):
    """Parse arguments, build the engine and the server; warm up once.
    `cfg` replaces the configuration that --cfg, the checkpoint directory's
    config.yaml or the TARS_* env would give (`load_models`); `engine`, an
    engine already built, replaces the engine and its configuration (a
    second server over the same models). Returns (server,
    engine); `server.service` is the ContinuousService in continuous mode
    (None in sequential mode), which its owner shuts down;
    `server.precompiled` the background precompile's future
    (`precompile_in_background`), None when TARS_PRECOMPILE=0 or without a
    default prompt."""
    p = argparse.ArgumentParser(prog="indextts-tpu-torch-serve")
    p.add_argument("--model-dir", default=os.environ.get("TARS_CHECKPOINT_DIR"),
                   help="reference-layout checkpoint directory (default: random weights)")
    p.add_argument("--cfg", default=os.environ.get("TARS_CONFIG_FILE"))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--reference-audio", default=None,
                   help="default speaker prompt wav")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    p.add_argument("--seed", type=int, default=0,
                   help="random-weights seed (without --model-dir)")
    p.add_argument("--num-beams", type=int,
                   default=int(os.environ.get("TARS_NUM_BEAMS", "1")),
                   help="decode route for serving. Default 1 (the captured "
                        "sampling loop); the reference's own accelerated "
                        "serving path ignores num_beams too (model_v2.py:"
                        "871-883). Set 3 for the reference HF-default "
                        "beam-multinomial route. Continuous batching samples "
                        "whatever this says.")
    args = p.parse_args(argv)
    # multi-process jobs: torch.distributed before any device use, as the
    # JAX server initializes jax.distributed; a strict no-op for one process
    from indextts_tpu_torch.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed(args.device)
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer
    from indextts_tpu_torch.utils.obs import print_stage, setup_logging

    setup_logging()
    if engine is None:
        t0 = time.perf_counter()
        print_stage("Loading models", "progress")
        engine = load_models(args, cfg)
        print_stage("Models loaded", "complete", time.perf_counter() - t0)
        if args.model_dir:
            attach_qwen(engine, args.model_dir)
    cfg = engine.cfg

    settings = ServerSettings(host=args.host, port=args.port)
    default_prompt = args.reference_audio or settings.reference_audio or None
    service = None
    slots = pick_continuous_slots(os.environ)
    if slots > 1:
        from indextts_tpu_torch.runtime.batcher import ContinuousService

        service = ContinuousService(
            engine, n_slots=slots, text_bucket=cfg.runtime.max_text_tokens_per_segment,
            chunk_steps=int(os.environ.get("TARS_CONTINUOUS_CHUNK", "32")),
            tail_workers=int(os.environ.get("TARS_CONTINUOUS_TAIL_WORKERS", "2")))
        print(f">> continuous batching: {slots} slots", file=sys.stderr)
    synth = make_synth(engine, default_prompt, service, args.num_beams)
    server = TTSServer(synth, settings,
                       stream_fn=make_synth_stream(engine, default_prompt, service,
                                                   args.num_beams),
                       device=engine.device)
    server.service = service
    server.precompiled = None
    if os.environ.get("TARS_PRECOMPILE", "1") == "1" and default_prompt:
        # before the warmup: the grid captures while the warmup runs
        server.precompiled = precompile_in_background(engine, default_prompt,
                                                      service is not None, args.num_beams)
    if settings.warmup and default_prompt:
        t0 = time.perf_counter()
        synth(text="warmup")
        print(f">> warmup done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return server, engine


def main(argv=None, on_built: Optional[Callable] = None):
    """Build and serve until shut down; `on_built(server, engine)`, when
    given, is called once both are built (tools/soak_server.py reads the
    engine's captured graphs through it)."""
    from indextts_tpu_torch.utils.obs import GracefulShutdown, print_stage

    server, engine = build(argv)
    if on_built is not None:
        on_built(server, engine)
    GracefulShutdown().install()
    print_stage(f"Serving on {server.settings.host}:{server.settings.port}", "complete")
    server.run()


if __name__ == "__main__":
    main()

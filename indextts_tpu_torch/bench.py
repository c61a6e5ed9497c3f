#!/usr/bin/env python
"""End-to-end synthesis benchmark of the port on the card.

  python -m indextts_tpu_torch.bench                 # the card; JSON lines on stdout
  BENCH_TINY=1 python -m indextts_tpu_torch.bench    # the tiny config on the CPU

Counterpart of bench.py: the full-size IndexTTS2 cascade (seeded random
weights) with a fixed number of decoded codes a segment (the stop token
banned), reporting steady-state audio seconds generated per wall second.
`vs_baseline` is the ratio to the reference's 9.25 s of audio in 169.4 s on
an RTX 2070 (BASELINE.md), as in JAX.

Output: JSON lines on stdout. The headline line comes as soon as the timed
runs end and is emitted again after each optional section, each later line
a superset of it, so the last complete line carries the most. An internal
budget (BENCH_BUDGET_S, default 1500 s) skips optional sections instead of
dying inside them; each skip is named in `sections_skipped`.

The environment is bench.py's: BENCH_QUANT (1: W8A8 GPT, int8 KV, bf16
s2mel and vocoder; 0: float32), BENCH_WBITS, BENCH_DIFFUSION_STEPS,
TARS_HEAD_QUANT, TARS_S2MEL_DTYPE, TARS_VOC_DTYPE; BENCH_UNKEYED,
BENCH_NUM_BEAMS, BENCH_TEXT_TOKENS, BENCH_MEL_TOKENS, BENCH_RUNS,
BENCH_PARALLEL_WARM, BENCH_WARM_WORKERS; BENCH_BATCH (the BATCHED
section's batch sizes, "8,16"), BENCH_BATCH_E2E (8); BENCH_<SECTION>=0
turns a section off (STAGES, SEQ_TAIL, BATCHED, BATCHED_E2E, BEAM). The
GPT computes in bfloat16, as bench.py's engine does.

Differences from bench.py:
- The headline adds `device` ({name, power_limit_w}: the card's name and
  its power limit from nvidia-smi), `launches` (each kernel's launches over
  the timed runs), `timed_stages` (each stage's seconds summed over the
  timed runs: `tokens_per_s` is BENCH_MEL_TOKENS x BENCH_RUNS over their
  gpt_gen), `codes_decoded` (the codes the timed runs decoded, which the
  banned stop token makes BENCH_MEL_TOKENS x BENCH_RUNS) and
  `sections_failed`. An optional section that raises is skipped and the
  headline still emitted, but the section is named in `sections_failed`
  and the process exits 1 at the end (bench.py logs and exits 0, which
  would hide a broken route). A warm-up (`engine.precompile`) that raises
  is named there as "warmup" in the same way.
- Left out, TPU-only: the claim-wait loop (BENCH_CLAIM_WAIT_MIN) and the
  XLA compile cache (JAX_COMPILE_CACHE). "Prewarmed" means the port's
  build directory (utils/build.py `build_dir`, INDEXTTS_TORCH_BUILD_DIR)
  already held built libraries when the process started; the startup
  sidecar `startup_history.json` lives there too. BENCH_TINY=1 defaults
  that directory to one of its own under the temporary directory, so the
  self-test never flips the real bench's classification.
- BENCH_RANDOM_PARAMS is not read: the port's `random_params` is always
  seeded (seed 0); JAX's constant fill has no counterpart, since it
  overflows the full-width vocoder.
- `quant` names the configuration that ran; for the defaults it is
  bench.py's string.
- `--device` (default: the card; BENCH_TINY=1 defaults to the CPU). Without
  a card and without `--device cpu` or BENCH_TINY=1 it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

T_PROC = time.time()
# the reference's 9.25 s of audio in 169.4 s (BASELINE.md row 1)
BASELINE_AUDIO_PER_S = 9.25 / 169.4
SECTIONS = ("STAGES", "SEQ_TAIL", "BATCHED", "BATCHED_E2E", "BEAM")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def tiny_config():
    """The tests' tiny config (tests/test_engine_e2e.py `tiny_config`),
    kept here so that BENCH_TINY=1 needs nothing of the tests."""
    from indextts_tpu_torch.config import (
        BigVGANConfig,
        CampPlusConfig,
        ConditionModuleConfig,
        DiTConfig,
        GPTConfig,
        IndexTTS2Config,
        LengthRegulatorConfig,
        RuntimeConfig,
        S2MelConfig,
        SemanticCodecConfig,
        W2VBertConfig,
        WaveNetConfig,
    )

    return IndexTTS2Config(
        gpt=GPTConfig(
            model_dim=64, layers=2, heads=4, max_mel_tokens=64, max_text_tokens=32,
            number_text_tokens=50, number_mel_codes=36, start_mel_token=34,
            stop_mel_token=35,
            condition_module=ConditionModuleConfig(
                output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
            emo_condition_module=ConditionModuleConfig(
                output_size=32, linear_units=32, attention_heads=2, num_blocks=1),
        ),
        semantic_codec=SemanticCodecConfig(
            codebook_size=36, hidden_size=1024, codebook_dim=8, vocos_dim=24,
            vocos_intermediate_dim=32, vocos_num_layers=1),
        s2mel=S2MelConfig(
            length_regulator=LengthRegulatorConfig(channels=32, in_channels=1024),
            dit=DiTConfig(hidden_dim=32, num_heads=4, depth=3, in_channels=80,
                          content_dim=32, style_dim=192),
            wavenet=WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
            gpt_dims=(64, 16, 8, 1024),
        ),
        vocoder=BigVGANConfig(
            num_mels=80, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),)),
        w2vbert=W2VBertConfig(
            hidden_size=1024, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, tap_layer=2, conv_depthwise_kernel_size=7),
        campplus=CampPlusConfig(),
        runtime=RuntimeConfig(diffusion_steps=2, max_mel_tokens=24),
    )


def bench_runtime(env=os.environ):
    """bench.py's RuntimeConfig from the environment `env`: BENCH_QUANT=1
    (the default) is W8A8 weights, an int8 KV cache and a bfloat16 s2mel and
    vocoder; 0 is float32 throughout."""
    from indextts_tpu_torch.config import RuntimeConfig

    quant = env.get("BENCH_QUANT", "1") == "1"
    fast_dt = "bfloat16" if quant else "float32"
    return RuntimeConfig(
        diffusion_steps=int(env.get("BENCH_DIFFUSION_STEPS", "20")),
        kv_quant=quant,
        gpt_quantize=quant,
        gpt_wbits=int(env.get("BENCH_WBITS", "8")),
        head_quant=env.get("TARS_HEAD_QUANT", "0") == "1",
        s2mel_dtype=env.get("TARS_S2MEL_DTYPE", fast_dt),
        voc_dtype=env.get("TARS_VOC_DTYPE", fast_dt),
    )


def bench_config(tiny: bool, env=os.environ):
    """The configuration the bench runs: the defaults with `bench_runtime`,
    or under `tiny` the tiny config with it, 2 diffusion steps, float32 and
    no quantization (bench.py's self-test mode)."""
    from indextts_tpu_torch.config import IndexTTS2Config

    runtime = bench_runtime(env)
    if tiny:
        return dataclasses.replace(
            tiny_config(),
            runtime=dataclasses.replace(
                runtime, diffusion_steps=2, s2mel_dtype="float32", voc_dtype="float32",
                kv_quant=False, gpt_quantize=False))
    return IndexTTS2Config(runtime=runtime)


def bench_inputs(cfg, tiny: bool, env=os.environ):
    """bench.py's inputs, drawn in its order from np.random.default_rng(0):
    (a 5-s 16 kHz prompt, its rate, the text ids, BENCH_MEL_TOKENS)."""
    rng = np.random.default_rng(0)
    sr = 16000
    prompt_arr = (rng.standard_normal(5 * sr) * 0.1).astype(np.float32)
    n_text = int(env.get("BENCH_TEXT_TOKENS", "8" if tiny else "64"))
    n_codes = int(env.get("BENCH_MEL_TOKENS", "16" if tiny else "400"))
    text = rng.integers(2, cfg.gpt.number_text_tokens, n_text)
    return prompt_arr, sr, text, n_codes


def bench_engine(cfg, params, device):
    """The bench's engine: the GPT in bfloat16 and a decoder that samples
    (top_k 30) with the stop token banned, so every segment decodes exactly
    its max_mel_tokens codes."""
    import torch

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, kv_int8

    engine = IndexTTS2Engine(cfg, params, device=device, gpt_dtype=torch.bfloat16)
    engine.decoder = GPTDecoder(
        engine.gpt, cfg.gpt, SamplingConfig(do_sample=True, top_k=30, ban_stop_token=True),
        kv_int8=kv_int8(cfg), attn_impl=cfg.runtime.attn_impl)
    return engine


def quant_label(rt) -> str:
    """The configuration's name in the headline (bench.py's for its two)."""
    if not rt.gpt_quantize:
        return "fp32"
    parts = [f"w{rt.gpt_wbits}a8"] + (["kv8"] if rt.kv_quant else []) + [
        f"{'bf16' if d == 'bfloat16' else 'fp32'}{name}"
        for name, d in (("s2mel", rt.s2mel_dtype), ("voc", rt.voc_dtype))]
    return "+".join(parts)


def has_libraries(path) -> bool:
    """Does the build directory `path` hold a built library?"""
    try:
        return any(e.name.endswith(".so") for e in os.scandir(path))
    except OSError:
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m indextts_tpu_torch.bench")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; BENCH_TINY=1: the CPU)")
    args = ap.parse_args(argv)
    budget = float(os.environ.get("BENCH_BUDGET_S", "1500"))

    def elapsed():
        return time.time() - T_PROC

    def remaining():
        return budget - elapsed()

    tiny = os.environ.get("BENCH_TINY", "0") == "1"
    if tiny:
        # the self-test's libraries and sidecar in a directory of their own
        os.environ.setdefault("INDEXTTS_TORCH_BUILD_DIR", os.path.join(
            tempfile.gettempdir(), "indextts_tpu_torch_build_tiny"))
    import torch

    from indextts_tpu_torch.ops import launch_snapshot, launches_since
    from indextts_tpu_torch.runtime.engine import next_bucket, random_params
    from indextts_tpu_torch.utils.build import build_dir
    from indextts_tpu_torch.utils.device import card_info, resolve_device

    dev = resolve_device(args.device or ("cpu" if tiny else None))
    kernels_dir = build_dir()
    prewarmed = has_libraries(kernels_dir)
    sidecar = kernels_dir / "startup_history.json"
    device = card_info(dev)
    log(f"device: {device} (budget {budget:.0f}s, build directory "
        f"{'prewarmed' if prewarmed else 'cold'})")

    cfg = bench_config(tiny)
    quant = cfg.runtime.gpt_quantize
    t0 = time.perf_counter()
    engine = bench_engine(cfg, random_params(cfg, seed=0, device=dev), dev)
    log(f"params initialized and engine built in {time.perf_counter() - t0:.1f}s")

    prompt_arr, sr, text, n_codes = bench_inputs(cfg, tiny)
    n_text = len(text)
    # the prompt as a PATH: a keyed request reuses the speaker's conditioning
    # across calls, as the serving deployment does (TARS_REFERENCE_AUDIO is a
    # path); BENCH_UNKEYED=1 passes (audio, rate) and conditions every request
    unkeyed = os.environ.get("BENCH_UNKEYED", "0") == "1"
    if unkeyed:
        prompt = (prompt_arr, sr)
    else:
        from indextts_tpu_torch.utils.audio import save_wav

        prompt = os.path.join(tempfile.mkdtemp(prefix="indextts_bench_"), "bench_prompt.wav")
        save_wav(prompt, prompt_arr, sr)
    # the sampling loop (num_beams=1) is the serving route; BENCH_NUM_BEAMS=3
    # measures the reference-default beam-multinomial route
    n_beams = int(os.environ.get("BENCH_NUM_BEAMS", "1"))

    # warm-up: capture exactly the programs the headline route replays, in
    # BENCH_WARM_WORKERS threads (IndexTTS2Engine.precompile); BENCH_PARALLEL_WARM=0
    # leaves them to the first infer
    warm_parallel_s = None
    warm_failed = False
    spk = None
    if os.environ.get("BENCH_PARALLEL_WARM", "1") == "1":
        try:
            t0 = time.perf_counter()
            spk = engine.prepare_speaker(prompt_arr, sr, cache_key=None if unkeyed else prompt)
            decode_bucket = min(next_bucket(n_text, 16, 16), cfg.gpt.max_text_tokens)
            n_warm = engine.precompile(
                spk, text_buckets=[decode_bucket], code_lens=[n_codes], max_new=n_codes,
                num_beams=n_beams, do_sample=True,
                decode_variants="raw" if unkeyed else "keyed",
                workers=int(os.environ.get("BENCH_WARM_WORKERS", "4")))
            warm_parallel_s = time.perf_counter() - t0
            log(f"parallel warmup: {n_warm} programs in {warm_parallel_s:.1f}s")
        except Exception as e:  # the first infer captures what is missing
            traceback.print_exc()
            log(f"parallel warmup failed (first infer will capture): {e!r}")
            warm_failed = True

    t0 = time.perf_counter()
    out = engine.infer(prompt, [text], seed=0, max_mel_tokens=n_codes, num_beams=n_beams,
                       do_sample=True)
    compile_time = time.perf_counter() - t0
    if warm_parallel_s is not None:
        compile_time += warm_parallel_s
    startup_s = elapsed()
    log(f"warmup (incl. capture): {compile_time:.1f}s, audio={out['duration_sec']:.2f}s; "
        f"startup {startup_s:.1f}s")

    # cold/warm startup sidecar, keyed by a signature of the configuration
    # and platform so that another configuration never seeds this one's cold
    # number
    sig = "|".join([dev.type, "tiny" if tiny else "full", f"quant={quant}",
                    f"wbits={cfg.runtime.gpt_wbits}", f"beams={n_beams}",
                    f"text={n_text}", f"mel={n_codes}"])
    cold_startup_s = None if prewarmed else round(startup_s, 1)
    try:
        hist = json.loads(sidecar.read_text()) if sidecar.exists() else []
        for h in hist:
            if not h.get("prewarmed") and cold_startup_s is None and h.get("sig") == sig:
                cold_startup_s = h.get("startup_s")
        hist.append({"ts": time.time(), "startup_s": round(startup_s, 1),
                     "prewarmed": prewarmed, "sig": sig, "warmup_s": round(compile_time, 1)})
        kernels_dir.mkdir(parents=True, exist_ok=True)
        sidecar.write_text(json.dumps(hist[-50:]))
    except (OSError, ValueError) as e:
        log(f"startup sidecar unavailable: {e}")

    n_runs = int(os.environ.get("BENCH_RUNS", "3"))
    total_wall = total_audio = 0.0
    stage_totals = {"gpt_gen": 0.0, "gpt_fwd": 0.0, "s2mel": 0.0, "bigvgan": 0.0}
    codes_decoded = 0
    before = launch_snapshot()
    for i in range(n_runs):
        t0 = time.perf_counter()
        out = engine.infer(prompt, [text], seed=i + 1, max_mel_tokens=n_codes,
                           num_beams=n_beams, do_sample=True)
        wall = time.perf_counter() - t0
        total_wall += wall
        total_audio += out["duration_sec"]
        for s in out["stats"]:
            codes_decoded += s.codes_len
            stage_totals["gpt_gen"] += s.gpt_gen_time
            stage_totals["gpt_fwd"] += s.gpt_forward_time
            stage_totals["s2mel"] += s.s2mel_time
            stage_totals["bigvgan"] += s.bigvgan_time
        log(f"run {i}: wall={wall:.2f}s audio={out['duration_sec']:.2f}s rtf={out['rtf']:.3f}")
    launches = launches_since(before)

    audio_per_s = total_audio / total_wall
    rtf = total_wall / total_audio
    log(f"steady-state: {audio_per_s:.2f} audio-sec/s (RTF {rtf:.3f})")
    result = {
        "metric": "audio_sec_generated_per_wall_sec",
        "value": round(audio_per_s, 3),
        "unit": "audio-sec/s",
        "vs_baseline": round(audio_per_s / BASELINE_AUDIO_PER_S, 2),
        "rtf": round(rtf, 4),
        "tokens_per_s": round(n_codes * n_runs / stage_totals["gpt_gen"], 1)
        if stage_totals["gpt_gen"] > 0 else None,
        "compile_s": round(compile_time, 1),
        "startup_s": round(startup_s, 1),
        "startup_prewarmed": prewarmed,
        "cold_startup_s": cold_startup_s,
        "parallel_warm_s": round(warm_parallel_s, 1) if warm_parallel_s is not None else None,
        "quant": quant_label(cfg.runtime),
        "budget_s": budget,
        "sections_skipped": [],
        "device": device,
        "launches": launches,
        "timed_stages": {k: round(v, 3) for k, v in stage_totals.items()},
        "codes_decoded": codes_decoded,
        "sections_failed": ["warmup"] if warm_failed else [],
    }

    def emit():
        # progressive re-emit: the last complete line wins
        print(json.dumps(result), flush=True)

    def failed(section: str, e: BaseException):
        traceback.print_exc()
        log(f"{section} failed: {e!r}")
        result["sections_failed"].append(section)

    emit()  # the headline cannot be lost from here on

    def want(section, est_s):
        """The budget gate of an optional section; est_s scales with this
        run's warm-up."""
        if os.environ.get(f"BENCH_{section}", "1") == "0":
            return False
        if remaining() < est_s:
            log(f"skipping {section}: est {est_s:.0f}s > remaining {remaining():.0f}s of budget")
            result["sections_skipped"].append(section.lower())
            return False
        return True

    def runtime_with(**kw):
        engine.cfg = dataclasses.replace(
            engine.cfg, runtime=dataclasses.replace(engine.cfg.runtime, **kw))

    # per-stage sequential breakdown with stage barriers (TARS_STAGE_SYNC=1,
    # which the engine reads): without them a stage's wait for the card lands
    # in the next stage's clock; from one extra pass, so the stage sum
    # matches the wall clock
    if want("STAGES", 30):
        try:
            os.environ["TARS_STAGE_SYNC"] = "1"
            for _ in range(2):
                out = engine.infer(prompt, [text], seed=99, max_mel_tokens=n_codes,
                                   num_beams=n_beams, do_sample=True)
            s = out["stats"][0]
            result["stages"] = {"gpt_gen": round(s.gpt_gen_time, 3),
                                "gpt_fwd": round(s.gpt_forward_time, 3),
                                "s2mel": round(s.s2mel_time, 3),
                                "bigvgan": round(s.bigvgan_time, 3)}
            log(f"sequential stages (sync'd): {result['stages']} "
                f"(sum {sum(result['stages'].values()):.3f}s)")
        except Exception as e:
            failed("stages", e)
        finally:
            os.environ.pop("TARS_STAGE_SYNC", None)
        emit()

    # sequential tail-overlap A/B: a 4-segment request with the cascade tail
    # pipelined against the next segment's decode (the serving default) and
    # strictly inline; every program is warm from the single-segment runs
    if want("SEQ_TAIL", 60):
        segs = [text] * 4
        ab = {}
        try:
            for label, flag in (("overlap", True), ("inline", False)):
                runtime_with(seq_tail_overlap=flag)
                for rep in range(2):  # settle, then time
                    t0 = time.perf_counter()
                    out = engine.infer(prompt, segs, seed=31 + rep, max_mel_tokens=n_codes,
                                       num_beams=n_beams, do_sample=True)
                    bt = time.perf_counter() - t0
                ab[label] = round(out["duration_sec"] / bt, 2)
                log(f"seq 4-seg {label}: wall={bt:.2f}s audio={out['duration_sec']:.2f}s "
                    f"-> {ab[label]} audio-sec/s")
            result["seq_tail"] = dict(ab, segments=4)
        except Exception as e:
            failed("seq_tail", e)
        finally:
            runtime_with(seq_tail_overlap=True)
        emit()

    # batched AR decode throughput (continuous-batching proxy): B sequences
    # decoded together by GPTDecoder.generate, at B=8 and B=16
    est_batched = 0.35 * compile_time + 30
    if want("BATCHED", est_batched):
        from indextts_tpu_torch.runtime.engine import EmotionConditioning

        batched_tok_s = {}
        try:
            spk = spk or engine.prepare_speaker(prompt_arr, sr, cache_key="bench")
            # JAX's _emovec_program and _build_conds_program: the speaker's
            # own features drive the emotion, alpha 1
            _, conds = engine.segment_conds(
                spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len))
            batch_sizes = [int(b) for b in os.environ.get("BENCH_BATCH", "8,16").split(",")]
            for B in batch_sizes:
                if remaining() < est_batched / 2:
                    log(f"skipping batched B={B}: budget")
                    result["sections_skipped"].append(f"batched_b{B}")
                    break
                conds_b = conds.expand(B, -1, -1).contiguous()
                ids, pos, valid = engine.decoder.build_text_prompt_arrays(
                    np.tile(text[None], (B, 1)), np.full(B, n_text), bucket=n_text)
                for rep in range(2):  # capture, then time
                    t0 = time.perf_counter()
                    res = engine.decoder.generate(
                        conds_b, engine._tensor(ids), engine._tensor(pos),
                        engine._tensor(valid), 7, max_new=n_codes)
                    res.codes.cpu()
                    bt = time.perf_counter() - t0
                batched_tok_s[B] = B * n_codes / bt
                log(f"batched decode B={B}: {bt:.2f}s -> {batched_tok_s[B]:.0f} tok/s "
                    f"({batched_tok_s[B] * 0.02:.1f} audio-sec/s decode-only)")
        except Exception as e:  # optional section: the headline stays
            failed("batched", e)
        if batched_tok_s:
            result["batched_decode_tok_s"] = round(
                batched_tok_s.get(8, next(iter(batched_tok_s.values()))), 1)
            if 16 in batched_tok_s:
                result["batched_decode_tok_s_b16"] = round(batched_tok_s[16], 1)
        emit()

    # batched end to end: one request of B segments through one decode of B
    # rows and one batched latent pass, solve and vocoder call
    if want("BATCHED_E2E", 0.5 * compile_time + 40):
        try:
            n_seg = int(os.environ.get("BENCH_BATCH_E2E", "8"))
            segs = [text for _ in range(n_seg)]
            for rep in range(2):  # capture, then time
                t0 = time.perf_counter()
                out = engine.infer(prompt, segs, seed=11, max_mel_tokens=n_codes,
                                   batched=True, num_beams=1, do_sample=True)
                bt = time.perf_counter() - t0
            result["batched_e2e_audio_s"] = round(out["duration_sec"] / bt, 2)
            log(f"batched e2e B={n_seg}: wall={bt:.2f}s audio={out['duration_sec']:.2f}s -> "
                f"{result['batched_e2e_audio_s']:.2f} audio-sec/s "
                f"(rtf {bt / out['duration_sec']:.3f})")
            # the per-stage batched breakdown, from extra passes with stage
            # barriers (the number above stays without them); the second kept
            os.environ["TARS_STAGE_SYNC"] = "1"
            try:
                for _ in range(2):
                    engine.infer(prompt, segs, seed=11, max_mel_tokens=n_codes,
                                 batched=True, num_beams=1, do_sample=True)
                    result["batched_stages"] = {
                        k: round(v, 3)
                        for k, v in getattr(engine, "_last_batched_stats", {}).items()}
                log(f"batched e2e stages (sync'd): {result['batched_stages']}")
            finally:
                os.environ.pop("TARS_STAGE_SYNC", None)
        except Exception as e:
            failed("batched_e2e", e)
        emit()

    # the reference-default serving route: beam-multinomial, 3 beams
    if n_beams == 1 and want("BEAM", 0.5 * compile_time + 20):
        try:
            for rep in range(2):  # capture, then time
                t0 = time.perf_counter()
                out = engine.infer(prompt, [text], seed=21, max_mel_tokens=n_codes,
                                   num_beams=3, do_sample=True)
                bt = time.perf_counter() - t0
            result["beam3_audio_s"] = round(out["duration_sec"] / bt, 2)
            log(f"beam-3 e2e: wall={bt:.2f}s audio={out['duration_sec']:.2f}s -> "
                f"{result['beam3_audio_s']:.2f} audio-sec/s")
        except Exception as e:
            failed("beam", e)
        emit()

    emit()  # the last line carries the sections the budget skipped
    log(f"bench complete in {elapsed():.1f}s (skipped: {result['sections_skipped'] or 'none'}; "
        f"failed: {result['sections_failed'] or 'none'}); {torch.__version__} on {device}")
    return 1 if result["sections_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())

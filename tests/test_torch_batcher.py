"""The port's continuous batcher (runtime/batcher.py) on the CPU.

* The port's ContinuousBatcher against the JAX package's, greedy, fp32, on
  the tiny config with the JAX parity parameters: 5 requests on 2 slots,
  chunk_steps=4, bucket 8, max_new 12; float and int8 KV caches. Codes
  token-exact.
* The JAX batcher's caches are two keys short (its cap counts 32
  conditioning positions, the prompt carries 34), so a request that runs to
  max_new gets its last code from a step whose own key overwrote an earlier
  one. On one seed this moves a code; the port's batcher gives the JAX
  individual decode's codes there.
* The port's batcher against its own sequential greedy `generate` on the
  float, W8 and W4 routes, with requests that run to max_new.
* A batched step against each row's single-row step at unequal positions
  and holes, and at 20 slots on the quantized routes, where every decode
  call takes the GEMV/MLP wrappers; priority admission and aging; oversize
  text; the service end to end against the sequential `infer`;
  cancellation and shutdown; a submit to a stopped service failing at
  once; `pick_continuous_slots`; the slot caches' size; one POST /tts in
  continuous mode; a second server built over an engine already built.

The card's captured batched step is held to the eager one in
tests/test_torch_cuda.py.
"""

import asyncio
import http.client
import io
import json
import threading
import time
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from torch_parity import n, parity_config, parity_params, speech_like, t, to_port_config

BUCKET, MAX_NEW, CHUNK = 8, 12, 4


def _requests(scale: float = 1.0, count: int = 5):
    """`count` requests: conds (1, 34, 64) and 3-6 text ids each, seeded."""
    out = []
    for i in range(count):
        conds = (scale * np.random.default_rng(100 + i).standard_normal((1, 34, 64))
                 ).astype(np.float32)
        out.append((conds, np.random.default_rng(200 + i).integers(2, 50, 3 + i % 4)))
    return out


def _decoders(seed: int, kv_int8: bool):
    """The JAX decoder (attn_impl "xla", kv_quant as asked) with its GPT
    parameters, and the port's greedy decoder on the same weights."""
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu_torch.runtime.engine import load_model

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=seed)
    jdec = JDecoder(JUV(cfg.gpt, kv_quant=kv_int8), cfg.gpt, JSampling(do_sample=False))
    gpt = load_model("gpt", pcfg, from_jax_params(jp, pcfg)["gpt"], "cpu")
    pdec = GPTDecoder(gpt, pcfg.gpt, SamplingConfig(do_sample=False), kv_int8=kv_int8)
    return jdec, {"params": jp["gpt"]}, pdec


def _jax_batch(jdec, jparams, reqs):
    from indextts_tpu.runtime.batcher import ContinuousBatcher as JBatcher

    bat = JBatcher(jdec, jparams, n_slots=2, text_bucket=BUCKET, max_new=MAX_NEW,
                   chunk_steps=CHUNK)
    for conds, text in reqs:
        bat.submit(jnp.asarray(conds), text)
    return bat, [c.codes for c in bat.run()]


def _port_batch(pdec, reqs, n_slots=2, max_new=MAX_NEW):
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    bat = ContinuousBatcher(pdec, n_slots=n_slots, text_bucket=BUCKET, max_new=max_new,
                            chunk_steps=CHUNK)
    ids = [bat.submit(t(conds), text) for conds, text in reqs]
    done = bat.run()
    assert [c.req_id for c in done] == ids
    return bat, [c.codes for c in done]


@pytest.mark.parametrize("kv_int8,seed", [(False, 1), (True, 14)])
def test_batcher_matches_jax_batcher_greedy(kv_int8, seed):
    """Token-exact codes, float32, float and int8 KV caches. The float
    weights' seed gives rows that run to max_new (12) and one that stops.
    On int8, an int8 rounding turns float32 noise into a one-step flip, so
    (the rule of tests/test_torch_quant.py) the weights' seed is one whose
    greedy paths have top-2 margins of at least 0.03 (0.037; its rows stop
    after 7 codes)."""
    jdec, jparams, pdec = _decoders(seed, kv_int8)
    reqs = _requests()
    _, want = _jax_batch(jdec, jparams, reqs)
    bat, got = _port_batch(pdec, reqs)
    assert (bat.state.caches[0].dtype == torch.int8) == kv_int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    lengths = [len(g) for g in got]
    assert len(set(np.concatenate(got).tolist())) > 3  # not degenerate rows
    assert MAX_NEW in lengths if not kv_int8 else max(lengths) < MAX_NEW


def test_jax_batcher_cap_fault_is_not_ported():
    """The JAX batcher's cap is S + max_new - 2 (batcher.py:76), the port's
    at least S + max_new. With seed 2's weights and conds scaled by 0.3,
    request 3 runs to max_new and the JAX batcher's last code differs from
    the JAX individual decode's; the port's batcher gives the individual
    decode's codes for every request."""
    jdec, jparams, pdec = _decoders(2, False)
    reqs = _requests(scale=0.3)
    jbat, jcodes = _jax_batch(jdec, jparams, reqs)
    pbat, pcodes = _port_batch(pdec, reqs)
    assert jbat.cap + 2 == pbat.prompt_len + MAX_NEW <= pbat.cap
    individual = []
    for conds, text in reqs:
        arrays = jdec.build_text_prompt_arrays(text[None], np.array([len(text)]), BUCKET)
        r = jdec.generate(jparams, jnp.asarray(conds), *(jnp.asarray(a) for a in arrays),
                          jax.random.PRNGKey(0), max_new=MAX_NEW)
        individual.append(np.asarray(r.codes)[0, :int(np.asarray(r.lengths)[0])])
    for p, w in zip(pcodes, individual):
        np.testing.assert_array_equal(p, w)
    differs = [i for i, (j, w) in enumerate(zip(jcodes, individual))
               if not np.array_equal(j, w)]
    assert differs == [3] and len(individual[3]) == MAX_NEW
    np.testing.assert_array_equal(jcodes[3][:-1], individual[3][:-1])


# route: (gpt_quantize, gpt_wbits)
ROUTES = {"float": (False, 8), "w8": (True, 8), "w4": (True, 4)}


def _route_decoder(route: str, do_sample: bool = False):
    """A 2-layer GPT of width 256 (4 heads of 64) on `route` with seeded
    random weights and, on the quantized routes, the int8 head, the int8 KV
    cache and gemv=True: every decode gate opens, so the steps take K4-K8's
    plain versions at n_slots rows. Its decoder on the CPU."""
    from indextts_tpu_torch import config as C
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    cfg = C.GPTConfig(
        model_dim=256, layers=2, heads=4, max_mel_tokens=64, max_text_tokens=32,
        number_text_tokens=50, number_mel_codes=36, start_mel_token=34, stop_mel_token=35,
        condition_module=C.ConditionModuleConfig(
            output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
        emo_condition_module=C.ConditionModuleConfig(
            output_size=32, linear_units=32, attention_heads=2, num_blocks=1))
    quantize, wbits = ROUTES[route]
    with torch.random.fork_rng(), torch.no_grad():
        torch.manual_seed(0)
        model = UnifiedVoice(cfg)
        # GPT-2's std 0.02 leaves the residual stream to the token's
        # embedding, and every prompt to one code row; fan-in scaling lets
        # the prompt decide
        for w in model.gpt.parameters():
            if w.dim() == 2:
                w.normal_(0.0, w.shape[0] ** -0.5)
    if quantize:
        sd = quantize_gpt_state_dict(model.state_dict(), head=True, bits=wbits)
        with torch.device("meta"):
            model = UnifiedVoice(cfg, quantize=True, head_quant=True, wbits=wbits, gemv=True)
        model.load_state_dict(sd, strict=True, assign=True)
    model = model.eval().requires_grad_(False)
    return GPTDecoder(model, cfg, SamplingConfig(do_sample=do_sample, top_k=20),
                      kv_int8=quantize)


def _route_requests(count: int = 5):
    out = []
    for i in range(count):
        rng = np.random.default_rng(300 + i)
        out.append((rng.standard_normal((1, 34, 256)).astype(np.float32),
                    rng.integers(2, 50, 2 + (3 * i) % 7)))
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_batcher_matches_sequential_generate(route):
    """The port's batcher (3 slots, 5 requests, max_new 20) and its own
    sequential greedy generate at the same bucket: equal codes, on each
    route; at least one request runs to max_new."""
    dec = _route_decoder(route)
    reqs = _route_requests()
    max_new = 20
    _, got = _port_batch(dec, reqs, n_slots=3, max_new=max_new)
    for (conds, text), g in zip(reqs, got):
        arrays = dec.build_text_prompt_arrays(text[None], np.array([len(text)]), BUCKET)
        r = dec.generate(t(conds), *(t(a) for a in arrays), None, max_new=max_new,
                         do_sample=False)
        np.testing.assert_array_equal(g, n(r.codes)[0, :int(r.lengths[0])])
    assert max(len(g) for g in got) == max_new
    assert len(set(np.concatenate(got).tolist())) > 3


@pytest.mark.parametrize("route", list(ROUTES))
def test_batched_step_matches_single_row_steps(route):
    """Four slots at unequal positions (admitted 0, 3, 5 and 9 steps
    apart) and unequal holes (text of 2-8 ids in a bucket of 8): one
    batched greedy step's logits against each row's single-row step on a
    copy of its caches, within 1e-5 of the row's largest logit (float32
    products of 4 rows and of 1 summed in another order; on the quantized
    routes an int8 rounding may follow that noise). The picked codes are
    equal."""
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    dec = _route_decoder(route)
    bat = ContinuousBatcher(dec, n_slots=4, text_bucket=BUCKET, max_new=30, chunk_steps=1)
    st = bat.state
    with torch.inference_mode():
        for (conds, text), steps in zip(_route_requests(4), (3, 2, 4, 0)):
            bat.submit(t(conds), text)
            bat._admit()
            for _ in range(steps):
                dec.slot_step(st, False)
        assert len(set(n(st.pos).tolist())) == 4 and len(set(n(st.hole_s).tolist())) > 1
        rows = [st.row(b) for b in range(4)]
        dec.slot_step(st, False)
        for b, one in enumerate(rows):
            dec.slot_step(one, False)
            want = n(one.logits[0])
            err = np.abs(n(st.logits[b]) - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (b, err)
            assert torch.equal(one.codes[0], st.codes[b])
            assert int(one.pos[0]) == int(st.pos[b])


@pytest.mark.parametrize("route", ["w8", "w4"])
def test_batched_step_takes_the_kernels_past_16_rows(route, monkeypatch):
    """20 slots, more rows than one K5-K8 launch takes (16): every decode
    call of the quantized blocks and of the int8 head goes to the GEMV and
    fused-MLP wrappers with all 20 rows (on the card they launch the
    kernels in chunks of rows; here they run their plain versions), none
    to the unfused contraction; W8 2 x 2 + 1 (the head) gemv_w8 and 2
    mlp_w8 calls, W4 4 gemv_w4, 2 mlp_w4 and the head's gemv_w8. The
    batched step's logits are each row's single-row step's within 1e-5 of
    the row's largest (as in test_batched_step_matches_single_row_steps),
    and its codes equal."""
    from indextts_tpu_torch.models import gpt2
    from indextts_tpu_torch.ops import gemv
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    dec = _route_decoder(route)
    bat = ContinuousBatcher(dec, n_slots=20, text_bucket=BUCKET, max_new=30, chunk_steps=1)
    st = bat.state
    with torch.inference_mode():
        for i, (conds, text) in enumerate(_route_requests(20)):
            bat.submit(t(conds), text)
            bat._admit()
            for _ in range(i % 3):
                dec.slot_step(st, False)
        rows = [st.row(b) for b in range(20)]
        calls = []
        for name in ("gemv_w8", "gemv_w4", "mlp_w8", "mlp_w4"):
            def counted(xq, *args, _name=name, _fn=getattr(gemv, name)):
                calls.append((_name, xq.shape[0]))
                return _fn(xq, *args)
            monkeypatch.setattr(gemv, name, counted)

        def unfused(*args):
            raise AssertionError("a decode call took the unfused contraction")

        monkeypatch.setattr(gpt2, "w8a8", unfused)
        dec.slot_step(st, False)
        monkeypatch.undo()
        want = ({"gemv_w8": 5, "mlp_w8": 2} if route == "w8"
                else {"gemv_w4": 4, "mlp_w4": 2, "gemv_w8": 1})
        assert {name: sum(1 for c in calls if c[0] == name) for name in want} == want
        assert len(calls) == sum(want.values()) and {r for _, r in calls} == {20}
        for b, one in enumerate(rows):
            dec.slot_step(one, False)
            want_logits = n(one.logits[0])
            err = np.abs(n(st.logits[b]) - want_logits).max()
            assert err <= 1e-5 * np.abs(want_logits).max(), (b, err)
            assert torch.equal(one.codes[0], st.codes[b])


def test_priority_admission_and_aging():
    """One slot: requests admit by priority (FIFO within a level); a request
    of priority 5 that has waited 6 x AGING_S longer than the others admits
    before those of priority 0 and 1. Text longer than the bucket raises."""
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher

    dec = _route_decoder("float")
    conds = t(_route_requests(1)[0][0])
    bat = ContinuousBatcher(dec, n_slots=1, text_bucket=BUCKET, max_new=3, chunk_steps=3)
    with pytest.raises(ValueError, match="exceeds bucket"):
        bat.submit(conds, np.arange(2, 2 + BUCKET + 1))
    ids = [bat.submit(conds, np.array([5, 6]), priority=p) for p in (2, 0, 1, 0)]
    assert [c.req_id for c in bat.completed] == []
    bat.run()
    assert [c.req_id for c in bat.completed] == [ids[1], ids[3], ids[2], ids[0]]
    bat.completed = []
    late = [bat.submit(conds, np.array([5, 6]), priority=p) for p in (0, 1, 5)]
    bat._queue[-1].enqueued_at -= 6 * bat.AGING_S  # priority 5 aged to -1
    bat.run()
    assert [c.req_id for c in bat.completed] == [late[2], late[0], late[1]]


def test_slot_caches_hold_prompt_and_max_new():
    """cap >= S + max_new for S = 34 + bucket + 2 + 1 at the serving
    defaults and at edges of the 256-slot rounding; a request that runs to
    max_new leaves its row at pos S + max_new, every write in range."""
    from indextts_tpu_torch.runtime.batcher import ContinuousBatcher
    from indextts_tpu_torch.runtime.decode import cache_cap

    for bucket, max_new in ((120, 1500), (120, 300), (8, 12), (219, 0), (219, 1), (3, 256)):
        S = 34 + bucket + 2 + 1
        assert cache_cap(S, max_new) >= S + max_new
    dec = _route_decoder("float")
    bat = ContinuousBatcher(dec, n_slots=2, text_bucket=BUCKET, max_new=20, chunk_steps=7)
    assert bat.prompt_len == 34 + BUCKET + 3 and bat.cap >= bat.prompt_len + 20
    conds, text = _route_requests(1)[0]
    bat.submit(t(conds), text)
    (c,) = bat.run()
    assert len(c.codes) == 20
    assert int(bat.state.pos[0]) == bat.prompt_len + 20 <= bat.cap


def _engine():
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    cfg = parity_config()
    pcfg = to_port_config(cfg)
    return IndexTTS2Engine(pcfg, from_jax_params(parity_params(cfg, seed=1), pcfg),
                           device="cpu")


@pytest.mark.parametrize("tail_workers", [0, 2])
def test_service_matches_sequential_infer(tail_workers):
    """ContinuousService end to end, greedy: 3 segments of one request, and
    a second request at the same time, through infer_continuous give the
    waveforms the sequential infer gives with the same seeds, to the bit
    (the same codes, then the same tail from seed + i)."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService

    eng = _engine()
    audio = (speech_like(np.random.default_rng(0), 1.2, 16000), 16000)
    segs = [np.random.default_rng(k).integers(2, 50, 4 + 3 * k) for k in range(3)]
    other = [np.random.default_rng(9).integers(2, 50, 6)]
    want = [eng.infer(audio, segs, seed=5)["audio"], eng.infer(audio, other, seed=8)["audio"]]
    svc = ContinuousService(eng, n_slots=2, text_bucket=12, max_new=24, chunk_steps=4,
                            tail_workers=tail_workers)
    got = [None, None]
    try:
        th = threading.Thread(target=lambda: got.__setitem__(
            1, eng.infer_continuous(svc, audio, other, seed=8)["audio"]))
        th.start()
        got[0] = eng.infer_continuous(svc, audio, segs, seed=5)["audio"]
        th.join(timeout=300)
        assert not th.is_alive()
    finally:
        svc.shutdown()
    assert not svc._thread.is_alive()
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def _gated_service(eng, **kw):
    """A service whose decode thread waits at `gate` before each chunk."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService

    svc = ContinuousService(eng, **kw)
    gate = threading.Event()
    step = svc.bat.step

    def gated():
        assert gate.wait(timeout=300)
        return step()

    svc.bat.step = gated
    return svc, gate


def test_cancel_and_shutdown(monkeypatch):
    """A future cancelled while queued stays cancelled and the others
    resolve; shutdown fails the pending futures; the decode thread, still in
    its chunk when the shutdown's join timed out, later harvests requests
    whose futures and metadata are gone without raising, and ends."""
    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    errors = []
    monkeypatch.setattr(threading, "excepthook", lambda a: errors.append(a.exc_value))
    eng = _engine()
    spk = eng.prepare_speaker(speech_like(np.random.default_rng(0), 1.2, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    svc, gate = _gated_service(eng, n_slots=1, text_bucket=8, max_new=4, chunk_steps=4)
    futs = [svc.submit(spk, emo, np.array([3, 4, 5]), seed=k) for k in range(3)]
    assert futs[1].cancel()
    gate.set()
    assert futs[0].result(timeout=300).wav.size and futs[2].result(timeout=300).wav.size
    assert futs[1].cancelled()

    gate.clear()
    late = svc.submit(spk, emo, np.array([3, 4, 5]), seed=7)
    t0 = time.perf_counter()
    while not svc._futures:  # the decode thread took it and waits at the gate
        assert time.perf_counter() - t0 < 60
        time.sleep(0.01)
    svc.shutdown(timeout=0.05)
    assert svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        late.result(timeout=1)
    gate.set()  # the chunk runs, harvests the request, finds no future
    svc._thread.join(timeout=300)
    assert not svc._thread.is_alive() and errors == []
    assert svc.bat.chunks >= 2 and not svc.bat.busy()


def test_submit_fails_fast_once_the_service_stopped(monkeypatch):
    """A chunk that raises ends the decode thread and fails the pending
    future with its error; a later submit fails at once, carrying that
    error, instead of queueing where no thread reads; after shutdown a
    submit fails at once too."""
    from indextts_tpu_torch.runtime.batcher import ContinuousService
    from indextts_tpu_torch.runtime.engine import EmotionConditioning

    errors = []
    monkeypatch.setattr(threading, "excepthook", lambda a: errors.append(a.exc_value))
    eng = _engine()
    spk = eng.prepare_speaker(speech_like(np.random.default_rng(0), 1.2, 16000), 16000)
    emo = EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
    svc = ContinuousService(eng, n_slots=1, text_bucket=8, max_new=4, chunk_steps=4)

    def broken():
        raise ValueError("chunk failed")

    svc.bat.step = broken
    first = svc.submit(spk, emo, np.array([3, 4, 5]), seed=0)
    with pytest.raises(ValueError, match="chunk failed"):
        first.result(timeout=60)
    svc._thread.join(timeout=60)
    assert not svc._thread.is_alive() and [type(e) for e in errors] == [ValueError]
    later = svc.submit(spk, emo, np.array([3, 4, 5]), seed=1)
    assert later.done()
    with pytest.raises(RuntimeError, match="decode loop failed") as info:
        later.result(timeout=0)
    assert info.value.__cause__ is errors[0]
    svc.shutdown(timeout=1)
    svc2 = ContinuousService(eng, n_slots=1, text_bucket=8, max_new=4, chunk_steps=4)
    svc2.shutdown(timeout=60)
    after = svc2.submit(spk, emo, np.array([3, 4, 5]), seed=2)
    assert after.done()
    with pytest.raises(RuntimeError, match="shut down"):
        after.result(timeout=0)


@pytest.mark.parametrize("env,slots", [
    ({}, 0), ({"TARS_MAX_CONCURRENCY": "3"}, 0), ({"TARS_MAX_CONCURRENCY": "4"}, 4),
    ({"TARS_MAX_CONCURRENCY": "8"}, 8), ({"TARS_MAX_CONCURRENCY": "16"}, 8),
    ({"TARS_CONTINUOUS_SLOTS": "2"}, 2),
    ({"TARS_CONTINUOUS_SLOTS": "0", "TARS_MAX_CONCURRENCY": "8"}, 0),
    ({"TARS_CONTINUOUS_SLOTS": "auto", "TARS_MAX_CONCURRENCY": "5"}, 5)])
def test_pick_continuous_slots(env, slots):
    """The port's table is the JAX server's."""
    from indextts_tpu.serve import pick_continuous_slots as jax_pick

    from indextts_tpu_torch.serve import pick_continuous_slots

    assert pick_continuous_slots(env) == jax_pick(env) == slots


def test_serve_continuous_tts_request(tmp_path, monkeypatch):
    """serve.build with TARS_CONTINUOUS_SLOTS=2 (device "cpu", the tiny
    config) serves through a ContinuousService: the warmup and two
    concurrent POST /tts answer mono 16-bit WAVs, /tts/stream answers 200
    with chunked PCM, the /tts answer's samples then 200 ms of silence
    (`infer_generator_continuous`), and the service shuts down."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.batcher import ContinuousService
    from indextts_tpu_torch.utils import audio as audio_utils

    monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("TARS_CONTINUOUS_SLOTS", "2")
    monkeypatch.setenv("TARS_MAX_CONCURRENCY", "2")
    wav_path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(wav_path, speech_like(np.random.default_rng(1), 1.0, 16000), 16000)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server, engine = serve.build(
        ["--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--reference-audio", wav_path], cfg=to_port_config(parity_config()))
    svc = server.service
    assert isinstance(svc, ContinuousService) and svc.bat.B == 2 and svc.bat.chunks > 0
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    fut = asyncio.run_coroutine_threadsafe(server.serve(), loop)
    answers = {}

    def post(path, text):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", path, body=json.dumps({"text": text, "seed": 3}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        answers[(path, text)] = (r.status, r.read())
        conn.close()

    try:
        t0 = time.time()
        while not server.ready:
            assert not fut.done() and time.time() - t0 < 30
            time.sleep(0.02)
        posts = [threading.Thread(target=post, args=("/tts", s)) for s in ("hello", "there")]
        for p in posts:
            p.start()
        for p in posts:
            p.join(timeout=300)
        post("/tts/stream", "hello")
    finally:
        fut.cancel()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
        server.pool.shutdown(wait=True)
        svc.shutdown()
    pcm = {}
    for text in ("hello", "there"):
        status, body = answers[("/tts", text)]
        assert status == 200, body[:200]
        with wave.open(io.BytesIO(body)) as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
            assert w.getnframes() > 0
            pcm[text] = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    status, body = answers[("/tts/stream", "hello")]
    assert status == 200, body[:200]
    n_sil = int(22050 * 200 / 1000)
    stream = np.frombuffer(body, np.int16)
    np.testing.assert_array_equal(stream[:-n_sil], pcm["hello"])
    assert not stream[-n_sil:].any()
    assert svc.bat.tokens > 0 and not svc._thread.is_alive()


def test_build_serves_an_engine_already_built(tmp_path, monkeypatch):
    """serve.build(engine=...) builds a second server over an engine that
    a first build made: the same engine comes back, and in continuous mode
    its service decodes with the engine's own GPT; the warmup runs through
    the service."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.utils import audio as audio_utils

    monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
    wav_path = str(tmp_path / "spk.wav")
    audio_utils.save_wav(wav_path, speech_like(np.random.default_rng(1), 1.0, 16000), 16000)
    argv = ["--host", "127.0.0.1", "--port", "0", "--device", "cpu",
            "--reference-audio", wav_path]
    first, engine = serve.build(argv, cfg=to_port_config(parity_config()))
    assert first.service is None
    monkeypatch.setenv("TARS_CONTINUOUS_SLOTS", "2")
    second, same = serve.build(argv, engine=engine)
    svc = second.service
    try:
        assert same is engine and svc.engine is engine
        assert svc.decoder.model is engine.decoder.model and svc.decoder is not engine.decoder
        assert svc.bat.B == 2 and svc.bat.chunks > 0
    finally:
        svc.shutdown()


def test_launch_counter_threads(monkeypatch):
    """Kernel wrappers count launches from several threads (the decode
    thread, tail workers, request threads): 8 threads add 2000 launches
    each with a short switch interval, half of them while their own
    current stream captures (faked per thread: the CPU build has no
    capture). Every launch outside capture counts once; a capturing
    thread's calls go to its own tally, which it takes back whole; the
    replays it adds after count as launches."""
    import sys

    from indextts_tpu_torch.ops.cuda_lib import LaunchCounter

    tls = threading.local()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(tls, "capturing", False))
    counter, taken = LaunchCounter(), []

    def work(capturing):
        tls.capturing = capturing
        for _ in range(2000):
            counter.add()
        if capturing:
            n = counter.take_captured()
            taken.append(n)
            counter.add_replayed(3 * n)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i % 2 == 0,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert taken == [2000] * 4
    assert counter.launches == 4 * 2000 + 4 * 3 * 2000

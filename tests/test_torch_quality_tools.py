"""The port's quality harness, soak gate and device-memory helpers
(indextts_tpu_torch/tools/eval_quality.py, tools/soak_server.py,
utils/obs.py) against the JAX package's on the CPU at the tiny size.

* The pure parts of eval_quality (WER tokens, edit distance, counts, the
  mock ASR exact and corrupted, the cmd backend, make_asr, cosine): the
  same results as tools/eval_quality.py on the same inputs; the hf backend
  without transformers raises instead of switching backends.
* campplus_style and emovec_of of one speech-like prompt: within 1e-4 of
  the largest value of JAX's (CAMPPlus's and the conditioning modules'
  tolerance, tests/test_torch_models.py).
* evaluate over two distinct prompts, one with an emotion vector, greedy
  with one beam, both engines given the same CFM noise: equal WER and meta
  flags, spk_sim, emo_sim and the controls' margins within 1e-3.
* main writes the artifact with random weights and the mock ASR.
* The soak over a stub server: a stable stub exits 0, a drifting one 1.
* get_hbm_usage("cpu") is {}; StageTimers, HBMTracker and torch_trace
  record.
"""

import asyncio
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from indextts_tpu_torch.tools import eval_quality as p_eval
from indextts_tpu_torch.tools import soak_server as p_soak
from indextts_tpu_torch.utils import audio as audio_utils
from indextts_tpu_torch.utils import obs
from indextts_tpu_torch.weights import from_jax_params
from torch_parity import parity_config, parity_params, speech_like, to_port_config

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

import eval_quality as j_eval  # noqa: E402

CFG = parity_config()
PCFG = to_port_config(CFG)
GREEDY = {"num_beams": 1, "do_sample": False}


def banks(cfg, seed: int = 11):
    """Seeded emotion and speaker banks of the config's shapes."""
    rng = np.random.default_rng(seed)
    rows = sum(cfg.emo_num)
    return (rng.standard_normal((rows, cfg.gpt.model_dim)).astype(np.float32) * 0.5,
            rng.standard_normal((rows, 192)).astype(np.float32))


@pytest.fixture
def saved_env():
    """The soak sets its TARS_* defaults in os.environ: put it back."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


# ---------------------------------------------------------------------------
# The pure parts
# ---------------------------------------------------------------------------


def _pure_cases():
    ref = "The quick brown fox, 2.5 percent — 共465篇，约315万字"
    return [
        ("tokenize", lambda m: m.tokenize_for_wer(ref)),
        ("tokenize_width", lambda m: m.tokenize_for_wer("ＡＢＣ It's 2.5%·DONE")),
        ("edit_distance", lambda m: [m.edit_distance(list(a), list(b)) for a, b in
                                     (("abcd", "abcd"), ("abcd", "axc"), ("", "ab"),
                                      ("ab", ""), ("kitten", "sitting"))]),
        ("wer_counts", lambda m: [m.wer_counts(ref, h) for h in
                                  (ref, "the quick fox 2 5 percent", "", "共465篇 约315万")]),
        ("mock_exact", lambda m: m.MockASR(drop=0.0).transcribe(None, 0, ref_text=ref)),
        ("mock_drop", lambda m: [m.MockASR(drop=d, seed=s).transcribe(None, 0, ref_text=ref)
                                 for d, s in ((0.5, 0), (0.3, 7), (0.9, 1))]),
        ("make_asr", lambda m: [(a.name, a.needs_ref, getattr(a, "drop", None))
                                for a in (m.make_asr("mock", mock_drop=0.25, seed=3),
                                          m.make_asr("cmd:echo {wav}"))]),
        ("cmd_asr", lambda m: m.make_asr("cmd:test -s {wav} && echo hello there").transcribe(
            np.full(800, 0.1, np.float32), 16000)),
        ("cosine", lambda m: [m.cosine(a, b) for a, b in
                              (([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]), ([1.0, 2.0], [-1.0, -2.0]),
                               ([1.0, 0.0], [0.0, 0.0]), ([0.3, -1.2, 4.0], [2.0, 0.5, 1.0]))]),
    ]


@pytest.mark.parametrize("name,fn", _pure_cases(), ids=[c[0] for c in _pure_cases()])
def test_pure_parts_match_jax(name, fn):
    assert fn(p_eval) == fn(j_eval)


def test_make_asr_unknown_and_hf_without_transformers(monkeypatch):
    for m in (p_eval, j_eval):
        with pytest.raises(ValueError):
            m.make_asr("nope")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="needs the transformers package"):
        p_eval.make_asr("hf:/nonexistent/asr")


# ---------------------------------------------------------------------------
# The probes and the harness against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on parity_params(seed=1) and the same
    emotion banks, precise shapes, no tokenizer (the byte path)."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    jp = parity_params(CFG, seed=1)
    emo_m, spk_m = banks(CFG)
    je = JaxEngine(CFG, jp, emo_matrix=emo_m, spk_matrix=spk_m, precise_shapes=True)
    pe = IndexTTS2Engine(PCFG, from_jax_params(jp, PCFG), device="cpu", precise_shapes=True,
                         emo_matrix=emo_m, spk_matrix=spk_m)
    return je, pe


@pytest.fixture(scope="module")
def prompts(tmp_path_factory):
    """Two distinct speech-like prompts of one length (the JAX engine
    compiles its conditioning programs once a length)."""
    d = tmp_path_factory.mktemp("quality")
    paths = []
    for i in range(2):
        p = str(d / f"prompt{i}.wav")
        audio_utils.save_wav(p, speech_like(np.random.default_rng(10 + i), 1.2, 16000), 16000)
        paths.append(p)
    return paths


@pytest.mark.parametrize("probe", ["campplus_style", "emovec_of"])
def test_probes_match_jax(engines, prompts, probe):
    je, pe = engines
    wav, sr = audio_utils.load_wav(prompts[0])
    want = np.asarray(getattr(j_eval, probe)(je, wav, sr))
    got = getattr(p_eval, probe)(pe, wav, sr)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _noise(shape):
    """CFM noise that depends on the shape alone, so both engines draw it
    alike in any order."""
    return np.random.default_rng(list(shape)).standard_normal(shape).astype(np.float32)


def test_evaluate_matches_jax(engines, prompts):
    je, pe = engines
    cases = [
        {"id": "a", "text": "first speaker case"},
        {"id": "b", "text": "second speaker", "spk_audio": prompts[1],
         "emo_vector": [0, 0, 0.8, 0, 0, 0, 0, 0]},
    ]
    out = {}
    for name, mod, eng in (("jax", j_eval, je), ("port", p_eval, pe)):
        eng._noise_hook = _noise
        try:
            out[name] = mod.evaluate(eng, cases, mod.MockASR(drop=0.0), spk_audio=prompts[0],
                                     seed=0, gen_kwargs=GREEDY)
        finally:
            eng._noise_hook = None
    j, p = out["jax"], out["port"]
    assert [r["id"] for r in p["cases"]] == ["a", "b"]
    for jr, pr in zip(j["cases"], p["cases"]):
        assert set(pr) == set(jr)
        for k in ("wer", "wer_errors", "ref_tokens", "emo_mode", "cached", "run_index",
                  "audio_dur_s"):
            assert pr[k] == jr[k], k
        for k in ("spk_sim", "emo_sim"):
            assert abs(pr[k] - jr[k]) <= 1e-3, (k, pr[k], jr[k])
    assert p["aggregate"]["wer"] == j["aggregate"]["wer"] == 0.0
    assert set(p["controls"]) == set(j["controls"])
    assert p["controls"]["spk_control_synthetic"] is False
    for part in ("spk", "emo"):
        assert len(p["controls"][part]) == len(j["controls"][part]) == 2
        for jr, pr in zip(j["controls"][part], p["controls"][part]):
            assert abs(pr["margin"] - jr["margin"]) <= 1e-3, (part, pr, jr)
            assert pr.get("cross_prompt") == jr.get("cross_prompt")
        key = f"{part}_margin_mean"
        assert abs(p["controls"][key] - j["controls"][key]) <= 1e-3
    flags = ("spk_sim_discriminative", "emo_sim_discriminative", "asr", "asr_needs_ref",
             "n_cases", "seed")
    assert {k: p["meta"].get(k) for k in flags} == {k: j["meta"].get(k) for k in flags}
    assert set(p["meta"]) == set(j["meta"])
    # the CPU engine captures no CUDA graph
    assert pe.captured_graphs() == {"decode": 0, "latent": 0, "s2mel": 0, "vocoder": 0}


def test_main_writes_the_artifact(prompts, tmp_path, monkeypatch):
    """main() on the CPU: JSONL in, the JSON artifact out (random weights,
    the tiny configuration through the port's load_config)."""
    import indextts_tpu_torch.config as pconfig

    monkeypatch.setattr(pconfig, "load_config", lambda *a, **k: PCFG)
    cases_path = tmp_path / "cases.jsonl"
    cases_path.write_text("".join(json.dumps(c) + "\n" for c in (
        {"id": "x", "text": "tiny case"},
        {"id": "y", "text": "tiny emo", "emo_alpha": 0.6})))
    out_path = tmp_path / "EVAL.json"
    p_eval.main(["--cases", str(cases_path), "--spk-audio", prompts[0], "--asr", "mock",
                 "--output", str(out_path), "--device", "cpu",
                 "--wav-dir", str(tmp_path / "wavs")])
    art = json.loads(out_path.read_text())
    meta = art["meta"]
    assert meta["weights"] == "random" and meta["asr"] == "mock"
    assert meta["device"] == "cpu" and meta["max_mel_tokens"] == PCFG.runtime.max_mel_tokens
    assert meta["model_dir"] is None and "random weights" in meta["note"]
    assert art["aggregate"]["wer"] == 0.0 and len(art["cases"]) == 2
    assert art["controls"]["spk_control_synthetic"] is True
    assert "spk_sim_discriminative" in meta
    assert (tmp_path / "wavs" / "x.wav").exists()


# ---------------------------------------------------------------------------
# The soak gate over a stub server
# ---------------------------------------------------------------------------


class _StubEngine:
    def captured_graphs(self):
        return {"decode": 1, "latent": 2, "s2mel": 1, "vocoder": 1}


def _stub_server(port, tmpdir, engine_fn, monkeypatch):
    """The port's TTSServer over `engine_fn` on `port`; serve.main patched
    to hand the soak a stub engine and wait."""
    from indextts_tpu_torch import serve
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer

    srv = TTSServer(engine_fn, ServerSettings(host="127.0.0.1", port=port, max_concurrency=4,
                                              cache_dir=tmpdir))
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.serve())

    threading.Thread(target=run, daemon=True).start()
    while not srv.ready:
        time.sleep(0.02)

    def fake_main(argv, on_built=None):
        assert "--reference-audio" in argv
        on_built(srv, _StubEngine())
        time.sleep(3600)  # the stub already serves on the port

    monkeypatch.setattr(serve, "main", fake_main)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_soak_passes_on_stable_stub(tmp_path, monkeypatch, saved_env):
    def engine(text="", **kw):
        time.sleep(0.02)
        return {"audio": np.zeros(1024, np.float32), "sampling_rate": 22050}

    port = _free_port()
    _stub_server(port, str(tmp_path / "cache"), engine, monkeypatch)
    for k in ("TARS_MAX_MEL_TOKENS", "TARS_GPT_QUANTIZE"):
        os.environ.pop(k, None)
    os.environ["TARS_PRECOMPILE"] = "1"  # the caller's environment wins
    out = tmp_path / "soak.json"
    rc = p_soak.main(["--requests", "12", "--clients", "2", "--waves", "3",
                      "--port", str(port), "--output", str(out), "--device", "cpu"])
    assert rc == 0
    assert os.environ["TARS_MAX_MEL_TOKENS"] == "192" and os.environ["TARS_PRECOMPILE"] == "1"
    assert os.environ["TARS_GPT_QUANTIZE"] == "1"
    report = json.loads(out.read_text())
    s = report["summary"]
    assert s["ok"] is True and s["requests"] == 12 and s["hbm_gauge"] == "unavailable"
    assert s["captured_keys_warm"] == s["captured_keys_last"] == 5
    assert len(report["waves"]) == 3
    assert all(w["n"] == 4 and w["p50_s"] > 0 and w["captured_keys"] == 5
               for w in report["waves"])


def test_soak_fails_on_latency_drift(tmp_path, monkeypatch, saved_env):
    """A server whose latency degrades over time fails the drift gate."""
    state = {"calls": 0}

    def engine(text="", **kw):
        state["calls"] += 1
        time.sleep(0.01 * state["calls"])  # monotonically slower
        return {"audio": np.zeros(1024, np.float32), "sampling_rate": 22050}

    port = _free_port()
    _stub_server(port, str(tmp_path / "cache"), engine, monkeypatch)
    rc = p_soak.main(["--requests", "12", "--clients", "2", "--waves", "3",
                      "--port", str(port), "--max-latency-drift", "1.2", "--device", "cpu"])
    assert rc == 1


# ---------------------------------------------------------------------------
# utils/obs.py
# ---------------------------------------------------------------------------


def test_obs_helpers_record(tmp_path):
    assert obs.get_hbm_usage("cpu") == {}
    assert obs.get_hbm_usage(torch.device("cpu")) == {}
    timers = obs.StageTimers()
    for _ in range(2):
        with timers.track("decode"):
            time.sleep(0.01)
    with timers.track("vocoder"):
        pass
    rep = timers.report()
    assert set(rep) == {"decode", "vocoder"} and rep["decode"] >= 0.02
    tracker = obs.HBMTracker(device="cpu")
    tracker.snapshot("load", "gpt")
    tracker.snapshot("serve")
    assert tracker.report() == [{"tag": "load", "model": "gpt"},
                                {"tag": "serve", "model": ""}]
    off = obs.HBMTracker(enabled=False)
    off.snapshot("x")
    assert off.report() == []
    with obs.hbm_profile("block", device="cpu"):
        pass
    obs.print_request_box("r1", "some text", duration=1.5, audio_len=3.0, rtf=0.5, done=True)
    with obs.torch_trace(str(tmp_path / "trace")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(Path(d).glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]

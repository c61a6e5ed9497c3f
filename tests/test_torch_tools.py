"""The port's offline tools (indextts_tpu_torch/tools/) against the JAX
package's tools/ on the same input, on the CPU at the tiny size.

One reference-layout directory (torch_parity `write_checkpoint_dir`), read
through a patched `load_config` by both packages (the tiny architecture is
not what a missing config.yaml means):

* verify_checkpoint: the same file inventory, component statuses, leaf and
  parameter counts and exit code on the sound directory, with feat2.pt of
  the wrong row count, and under --strict with s2mel.pth missing; the
  port's --synth reports ok with finite audio;
* voice_conditioning precompute: every array within 1e-4 of its largest
  value of JAX's (the conditioning modules' tolerance,
  tests/test_torch_models.py), the lengths equal; a bundle of either
  package loads in the other; a segment synthesized from the loaded bundle
  is the fresh conditioning's, bit for bit; `prepare` writes the same WAV
  and report;
* build_dataset --mock-inference: the same manifest lines (the WAV paths
  taken relative to each output directory, elapsed_s left out) and the
  same WAV bytes, thread and process backends; a resume appends only the
  new ids, in both;
* synthesize_clips make-input: the same file;
* a real build_dataset (2 threads, --deterministic) and a real `synth
  --batched` (texts the tiny GPT takes) through each package's engine:
  manifests with the same ids and fields.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from indextts_tpu_torch.runtime import engine as port_engine
from indextts_tpu_torch.runtime import loader as port_loader
from indextts_tpu_torch.tools import build_dataset as p_build
from indextts_tpu_torch.tools import synthesize_clips as p_clips
from indextts_tpu_torch.tools import verify_checkpoint as p_verify
from indextts_tpu_torch.tools import voice_conditioning as p_voice
from indextts_tpu_torch.utils import audio as audio_utils
from torch_parity import (n, parity_config, parity_params, speech_like, to_port_config,
                          write_checkpoint_dir)

sys.path.insert(0, str(Path(__file__).parent.parent / "tools"))

import build_dataset as j_build  # noqa: E402
import synthesize_clips as j_clips  # noqa: E402
import verify_checkpoint as j_verify  # noqa: E402
import voice_conditioning as j_voice  # noqa: E402

CFG = parity_config()
PCFG = to_port_config(CFG)
_JAX_ENGINES = {}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools_ckpt")
    write_checkpoint_dir(d, CFG, parity_params(CFG, seed=1))
    return d


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' load_config (the tools' and the loaders') return the
    tiny configuration; the JAX loader builds one engine a directory, kept
    for the module's tests, and writes no cache into it."""
    import indextts_tpu.config as jconfig
    import indextts_tpu.runtime.loader as jloader
    import indextts_tpu_torch.config as pconfig

    for mod, cfg in ((jconfig, CFG), (jloader, CFG), (pconfig, PCFG), (port_loader, PCFG)):
        monkeypatch.setattr(mod, "load_config", lambda *a, _c=cfg, **k: _c)
    real = jloader.load_engine

    def cached(model_dir, *a, **k):
        if str(model_dir) not in _JAX_ENGINES:
            _JAX_ENGINES[str(model_dir)] = real(str(model_dir), cfg=CFG, use_native_cache=False)
        return _JAX_ENGINES[str(model_dir)]

    monkeypatch.setattr(jloader, "load_engine", cached)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """A 2 s speech-like prompt at 22.05 kHz."""
    path = tmp_path_factory.mktemp("voice") / "voice.wav"
    audio_utils.save_wav(str(path), speech_like(np.random.default_rng(5), 2.0, 22050), 22050)
    return path


def _linked(src: Path, dst: Path, skip=()) -> Path:
    """`dst` holding a link to each entry of `src` but `skip`."""
    dst.mkdir()
    for p in src.iterdir():
        if p.name not in skip:
            (dst / p.name).symlink_to(p)
    return dst


def _reports(d, tmp_path, *flags):
    out = {}
    for name, tool in (("jax", j_verify), ("port", p_verify)):
        path = tmp_path / f"{name}.json"
        extra = ("--device", "cpu") if name == "port" else ()
        rc = tool.main(["--model-dir", str(d), "--output", str(path), *flags, *extra])
        out[name] = (rc, json.loads(path.read_text()))
    return out


def _summary(report):
    return {name: {k: c[k] for k in ("status", "leaves", "params", "shape", "expected")
                   if k in c}
            for name, c in report["components"].items()}


@pytest.mark.parametrize("case", ["sound", "emo_rows", "strict_missing"])
def test_verify_checkpoint_matches_jax(ckpt, tiny, tmp_path, case):
    """The same inventory, statuses, counts and exit code as the JAX tool:
    0 on the sound directory (the GPT with its text_head as an extra); 1
    with 7 emotion rows (LAYOUT MISMATCH); 1 under --strict without
    s2mel.pth (MISSING, "not in checkpoint dir")."""
    d, flags = ckpt, ()
    if case == "emo_rows":
        d = _linked(ckpt, tmp_path / "d", skip=("feat2.pt",))
        torch.save(torch.randn(7, CFG.gpt.model_dim), d / "feat2.pt")
    elif case == "strict_missing":
        d, flags = _linked(ckpt, tmp_path / "d", skip=("s2mel.pth",)), ("--strict",)
    got = _reports(d, tmp_path, *flags)
    (jrc, jrep), (prc, prep) = got["jax"], got["port"]
    assert prc == jrc == {"sound": 0, "emo_rows": 1, "strict_missing": 1}[case]
    assert prep["files"] == jrep["files"]
    assert _summary(prep) == json.loads(json.dumps(_summary(jrep)))
    assert prep["ok"] is jrep["ok"]
    assert prep["components"]["gpt" if case != "strict_missing" else "s2mel"]["status"] == (
        "ok" if case != "strict_missing" else "not in checkpoint dir")
    if case == "sound":
        assert prep["components"]["gpt"]["extra_paths_info"] == ["text_head.bias",
                                                                 "text_head.weight"]
    if case == "emo_rows":
        assert prep["components"]["emo_matrix"]["status"] == "LAYOUT MISMATCH"


def test_verify_checkpoint_synth(ckpt, tiny, voice, capsys):
    """--synth through the port's load_engine on the CPU: ok, finite audio
    of a positive length."""
    rc = p_verify.main(["--model-dir", str(ckpt), "--synth", "--spk-audio", str(voice),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"]
    assert report["synth"]["finite"] and report["synth"]["audio_s"] > 0


@pytest.fixture(scope="module")
def port_engine_cpu(ckpt):
    return port_loader.load_engine(str(ckpt), cfg=PCFG, device="cpu")


def test_precompute_matches_jax_and_cross_loads(ckpt, tiny, voice, tmp_path, port_engine_cpu):
    """precompute of both packages on one prompt: each array within 1e-4 of
    its largest value, the lengths equal; each package's loader reads the
    other's bundle to its values; a segment from the port's loaded bundle
    is the fresh conditioning's, bit for bit."""
    from indextts_tpu.runtime.engine import SpeakerConditioning as JSpk

    jpath, ppath = tmp_path / "jax.npz", tmp_path / "port.npz"
    assert j_voice.main(["precompute", "--audio", str(voice), "--output", str(jpath),
                         "--model-dir", str(ckpt)]) == 0
    assert p_voice.main(["precompute", "--audio", str(voice), "--output", str(ppath),
                         "--model-dir", str(ckpt), "--device", "cpu"]) == 0
    with np.load(jpath) as jz, np.load(ppath) as pz:
        assert set(jz.files) == set(pz.files) == set(p_voice.KEYS)
        for k in p_voice.KEYS:
            assert jz[k].shape == pz[k].shape, k
            if k in ("cond_len", "ref_mel_len"):
                assert int(jz[k]) == int(pz[k]), k
            else:
                err = np.abs(pz[k] - jz[k]).max() / np.abs(jz[k]).max()
                assert err <= 1e-4, f"{k}: {err:.2e} of the largest value"
        ports = {k: pz[k] for k in pz.files}
    from_jax = p_voice.load_precomputed_speaker(str(jpath), device="cpu")
    from_port = j_voice.load_precomputed_speaker(str(ppath))
    assert isinstance(from_jax, port_engine.SpeakerConditioning)
    assert isinstance(from_port, JSpk)
    with np.load(jpath) as jz:
        for k in p_voice.KEYS:
            assert np.array_equal(np.asarray(n(getattr(from_jax, k))), jz[k]), k
            assert np.array_equal(np.asarray(getattr(from_port, k)), ports[k]), k

    eng = port_engine_cpu
    fresh = eng.prepare_speaker(*audio_utils.load_wav(str(voice)))
    loaded = p_voice.load_precomputed_speaker(str(ppath), device="cpu")
    ids = np.arange(2, 14, dtype=np.int32)
    segs = [eng.synthesize_segment(s, port_engine.EmotionConditioning(s.spk_cond_emb,
                                                                      s.cond_len), ids, seed=3)
            for s in (fresh, loaded)]
    assert segs[0].wav.size > 0 and np.array_equal(segs[0].wav, segs[1].wav)


def test_prepare_matches_jax(tmp_path):
    """`prepare` on three clips of differing loudness and length: the same
    WAV bytes and the same report."""
    clips = tmp_path / "clips"
    clips.mkdir()
    rng = np.random.default_rng(9)
    for i, (sec, gain) in enumerate(((1.0, 0.2), (2.5, 0.9), (0.7, 0.5))):
        audio_utils.save_wav(str(clips / f"c{i}.wav"),
                             gain * speech_like(rng, sec, 16000) / 0.3, 16000)
    outs = {}
    for name, tool in (("jax", j_voice), ("port", p_voice)):
        wav = tmp_path / f"{name}.wav"
        assert tool.main(["prepare", "--input-dir", str(clips), "--output", str(wav),
                          "--target-duration", "3"]) == 0
        outs[name] = wav.read_bytes()
    assert outs["jax"] == outs["port"]


def _corpus(path: Path, ids):
    path.write_text("\n".join(json.dumps({"id": f"u{i}", "text": f"hello world number {i}"})
                              for i in ids) + "\n")
    return path


def _manifest(out: Path):
    """The manifest's rows, each WAV path relative to `out`, elapsed_s out."""
    rows = []
    for line in open(out / "manifest.jsonl"):
        row = json.loads(line)
        row.pop("elapsed_s", None)
        if "wav" in row:
            row["wav"] = os.path.relpath(row["wav"], out)
        rows.append(row)
    return rows


def _wavs(out: Path):
    return {p.name: p.read_bytes() for p in sorted((out / "wavs").iterdir())}


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_build_dataset_mock_matches_jax(tmp_path, backend):
    """--mock-inference, 6 utterances, 1 thread or 2 processes: the same
    manifest lines and WAV bytes; a resume with two more utterances appends
    only those, in both."""
    corpus = _corpus(tmp_path / "corpus.jsonl", range(6))
    workers = "1" if backend == "thread" else "2"
    outs = {name: tmp_path / name for name in ("jax", "port")}
    for name, tool in (("jax", j_build), ("port", p_build)):
        tool.main(["--input", str(corpus), "--out-dir", str(outs[name]), "--mock-inference",
                   "--backend", backend, "--workers", workers])
    first = _manifest(outs["port"])
    assert first == _manifest(outs["jax"]) and len(first) == 6
    assert _wavs(outs["port"]) == _wavs(outs["jax"])
    corpus = _corpus(tmp_path / "corpus.jsonl", range(8))
    for name, tool in (("jax", j_build), ("port", p_build)):
        tool.main(["--input", str(corpus), "--out-dir", str(outs[name]), "--mock-inference",
                   "--backend", backend, "--workers", workers])
    rows = _manifest(outs["port"])
    assert rows == _manifest(outs["jax"])
    assert rows[:6] == first and sorted(r["id"] for r in rows[6:]) == ["u6", "u7"]
    assert _wavs(outs["port"]) == _wavs(outs["jax"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_make_input_matches_jax(tmp_path, shuffle):
    flags = ["--count", "7"] + (["--shuffle", "--seed", "7"] if shuffle else [])
    for name, tool in (("jax", j_clips), ("port", p_clips)):
        assert tool.main(["make-input", "--output", str(tmp_path / f"{name}.jsonl"),
                          *flags]) == 0
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


def test_real_runs_match_jax_fields(ckpt, tiny, voice, tmp_path):
    """build_dataset (2 threads, --deterministic, the directory's engine,
    3 utterances) and synthesize_clips synth --batched of 2 clips (a
    --phrases file of texts the tiny GPT takes), each package's engine:
    the same ids with the same fields, no errors, and WAVs of a positive
    length."""
    corpus = _corpus(tmp_path / "corpus.jsonl", range(3))
    for name, tool in (("jax", j_build), ("port", p_build)):
        extra = ["--device", "cpu"] if name == "port" else []
        tool.main(["--input", str(corpus), "--out-dir", str(tmp_path / f"ds_{name}"),
                   "--workers", "2", "--deterministic", "--model-dir", str(ckpt),
                   "--spk-audio", str(voice), *extra])
    rows = {name: sorted(_manifest(tmp_path / f"ds_{name}"), key=lambda r: r["id"])
            for name in ("jax", "port")}
    assert [r["id"] for r in rows["port"]] == [r["id"] for r in rows["jax"]] == ["u0", "u1",
                                                                                 "u2"]
    for p, j in zip(rows["port"], rows["jax"]):
        assert set(p) == set(j) and "error" not in p and p["duration_sec"] > 0
    inp, phrases = tmp_path / "clips.jsonl", tmp_path / "phrases.txt"
    # texts within the tiny GPT's text positions, in the tiny bpe.model's words
    phrases.write_text("hello. hello\nhello, hello. hello\n")
    p_clips.main(["make-input", "--output", str(inp), "--phrases", str(phrases)])
    summaries = {}
    for name, tool in (("jax", j_clips), ("port", p_clips)):
        extra = ["--device", "cpu"] if name == "port" else []
        out = tmp_path / f"clips_{name}"
        assert tool.main(["synth", "--input", str(inp), "--reference", str(voice),
                          "--output-dir", str(out), "--model-dir", str(ckpt), "--batched",
                          *extra]) == 0
        summaries[name] = json.loads((out / "manifest.json").read_text())
    p, j = summaries["port"], summaries["jax"]
    assert set(p) == set(j) and p["total_clips"] == j["total_clips"] == 2
    assert [c["id"] for c in p["clips"]] == [c["id"] for c in j["clips"]]
    for pc, jc in zip(p["clips"], j["clips"]):
        assert set(pc) == set(jc) and "error" not in pc and pc["duration"] > 0
        assert (tmp_path / "clips_port" / pc["path"]).stat().st_size > 44

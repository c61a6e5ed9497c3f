"""The port's checkpoint loader (runtime/loader.py over runtime/torch_convert.py
and utils/safetensors.py) against the JAX package's runtime/loader.py, on the CPU.

One reference-layout directory at the tiny size (torch_parity
`write_checkpoint_dir`: parity_params through weights.from_jax_params,
written by chip_smoke.py's writer: gpt.pth with a text_head, s2mel.pth as
{"net"} with `module.` prefixes, weight-norm pairs, w2v-BERT safetensors with
layers past tap_layer and a masked_spec_embed, the banks, the stats and
bpe.model):

* For each model the port's state dict has the keys of
  `weights.from_jax_params` applied to the JAX loader's tree, every tensor
  equal to the bit; the port reads exactly the keys the JAX converter
  reads; the stats and banks are equal.
* The engines that the two loaders build: greedy codes equal, mel within
  1e-4 of its largest value and waveform within 1e-3 of its peak (the
  default route's tolerances, tests/test_torch_s2mel_graph.py and
  tests/test_torch_tail_buckets.py), the same tokenizer ids.
* The containers: {"model": sd}, a folded or weight-normed BigVGAN, extra
  keys ignored, a missing key named with its file; a partial directory
  filled with the port's random_params(cfg, seed=0); the safetensors
  reader against the `safetensors` package both ways; config.yaml against
  the JAX load_config.
* The converted-weights cache (torch_cache/): a first load writes it, a
  second converts nothing (a counting spy, as the JAX package's
  test_native_cache_reload_matches) and gives every state dict and aux
  tensor to the bit, and its engine the JAX engine's greedy codes;
  use_native_cache=False reads and writes nothing; a partial directory
  caches only what it had; a replaced gpt.pth is converted again; a write
  that fails is named on stderr and the engine loads; the JAX loader's
  jax_cache/ and torch_cache/ sit in one directory, neither read by the
  other package. The port's safetensors writer round-trips every dtype its
  reader takes, and the `safetensors` package reads what it writes.
* serve.build --model-dir answers POST /tts through the loaded bpe.model;
  a Qwen directory in it is attached (use_emo_text answers 200), one that
  fails to load is reported and left out; GET /ui and /metrics.
"""

import asyncio
import dataclasses
import errno
import http.client
import io
import json
import os
import shutil
import threading
import time
import wave

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from indextts_tpu_torch.runtime import loader
from indextts_tpu_torch.runtime import torch_convert as tc
from indextts_tpu_torch.runtime.engine import MODELS, random_params
from indextts_tpu_torch.utils.safetensors import (DTYPES, load_file, load_file_with_metadata,
                                                   save_file)
from indextts_tpu_torch.weights import from_jax_params
from test_torch_s2mel_graph import _request
from test_torch_slice import _free_port
from test_torch_tail_buckets import _noise
from torch_parity import (parity_config, parity_params, speech_like, to_port_config,
                          write_checkpoint_dir)

TEXT = "hello. hello"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(directory, JAX config, port config, the port's state dicts written,
    the aux arrays written)."""
    d = tmp_path_factory.mktemp("checkpoints")
    cfg = parity_config()
    sds, aux = write_checkpoint_dir(d, cfg, parity_params(cfg, seed=1))
    return d, cfg, to_port_config(cfg), sds, aux


@pytest.fixture(scope="module")
def converted(ckpt):
    """(JAX loader's state dicts through from_jax_params, its aux; the
    port's state dicts, its aux)."""
    from indextts_tpu.runtime.loader import convert_reference_checkpoints

    d, cfg, pcfg, _, _ = ckpt
    jparams, jaux = convert_reference_checkpoints(str(d), cfg)
    params, aux = loader.convert_reference_checkpoints(str(d), pcfg)
    return from_jax_params(jparams, pcfg), jaux, params, aux


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("name", list(MODELS))
def test_state_dicts_match_jax_loader(converted, name):
    want, _, got, _ = converted
    _assert_same(got[name], want[name])


def test_stats_and_banks_match_jax_loader(converted, ckpt):
    _, jaux, _, aux = converted
    assert set(aux) == set(jaux) == {"semantic_stats", "emo_matrix", "spk_matrix"}
    for a, b, w in zip(aux["semantic_stats"], jaux["semantic_stats"],
                       ckpt[4]["semantic_stats"]):
        assert np.array_equal(a, b) and np.array_equal(a, w)
    for key in ("emo_matrix", "spk_matrix"):
        assert np.array_equal(aux[key], jaux[key]) and np.array_equal(aux[key], ckpt[4][key])


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _reference_state(d, name):
    """Model `name`'s reference state dict as both loaders read it (float32
    numpy; s2mel: its net's three modules, prefixes stripped)."""
    hf = d / "hf"
    if name == "gpt":
        return tc.to_numpy_sd(torch.load(d / "gpt.pth"))
    if name == "s2mel":
        net = torch.load(d / "s2mel.pth")["net"]
        return {m: tc.strip_ddp_prefix(tc.to_numpy_sd(net[m])) for m in tc.S2MEL_MODULES}
    if name == "w2vbert":
        return tc.to_numpy_sd(load_file(hf / "w2v-bert-2.0" / "model.safetensors"))
    if name == "repcodec":
        return tc.to_numpy_sd(load_file(hf / "semantic_codec.safetensors"))
    if name == "campplus":
        return tc.to_numpy_sd(torch.load(hf / "campplus_cn_common.bin"))
    return tc.to_numpy_sd(torch.load(hf / "bigvgan_generator.pt")["generator"])


@pytest.mark.parametrize("name", list(MODELS))
def test_port_reads_the_keys_the_jax_converter_reads(ckpt, name):
    from indextts_tpu.runtime import torch_convert as jtc

    d, cfg, pcfg, _, _ = ckpt
    ref = _reference_state(d, name)
    if name == "s2mel":
        nets = {m: _Reads(sd) for m, sd in ref.items()}
        jtc.convert_s2mel(nets, depth=cfg.s2mel.dit.depth,
                          wn_layers=cfg.s2mel.wavenet.num_layers,
                          n_ratios=len(cfg.s2mel.length_regulator.sampling_ratios))
        jax_read = {f"{m}.{k}" for m, sd in nets.items() for k in sd.read}
        sd = _Reads({f"{m}.{k}": v for m, s in ref.items() for k, v in s.items()})
    else:
        sd = _Reads(ref)
        convert = {"gpt": lambda s: jtc.convert_unified_voice(s, cfg.gpt),
                   "w2vbert": lambda s: jtc.convert_w2vbert(s, cfg.w2vbert),
                   "repcodec": lambda s: jtc.convert_repcodec(s, cfg.semantic_codec),
                   "campplus": lambda s: jtc.convert_campplus(s, cfg.campplus),
                   "bigvgan": lambda s: jtc.convert_bigvgan(s, cfg.vocoder)}[name]
        convert(sd)
        jax_read, sd = sd.read, _Reads(ref)
    tc.convert(name, sd, pcfg, "test")
    assert sd.read == jax_read


@pytest.fixture(scope="module")
def engines(ckpt):
    """The JAX loader's engine and the port's, from the directory."""
    from indextts_tpu.runtime.loader import load_engine

    d, cfg, pcfg, _, _ = ckpt
    return (load_engine(str(d), cfg=cfg, use_native_cache=False),
            loader.load_engine(str(d), cfg=pcfg, device="cpu"))


def test_engines_match_jax_loader(engines):
    """Both at their default route: codes equal, mel within 1e-4 of its
    largest value, waveform within 1e-3 of its peak."""
    je, pe = engines
    assert pe.load_report.filled == [] and pe.device.type == "cpu"
    noise = _noise()
    jc, jm, jw, _ = _request(je, 0, noise)
    pc, pm, pw, _ = _request(pe, 0, noise)
    assert len(jc) > 2
    np.testing.assert_array_equal(pc, jc)
    assert pm.shape == jm.shape and pw.shape == jw.shape
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()
    peak = np.abs(jw).max()
    assert 0 < peak < 1.0  # off the clip, or the check says nothing
    assert np.abs(pw - jw).max() <= 1e-3 * peak


def test_tokenizers_match_jax_loader(engines):
    je, pe = engines
    ids = [tok.convert_tokens_to_ids(tok.tokenize(TEXT)) for tok in (je.tokenizer, pe.tokenizer)]
    assert ids[0] == ids[1] and len(ids[0]) > 2


def _dir_with(tmp_path, src, names, **files):
    """A directory holding `names` of `src` (symlinked) and `files`
    ({name: object to torch.save})."""
    for name in names:
        os.symlink(src / name, tmp_path / name)
    for name, obj in files.items():
        torch.save(obj, tmp_path / name)
    return str(tmp_path)


def test_gpt_in_a_model_container_loads(ckpt, converted, tmp_path):
    d, _, pcfg, _, _ = ckpt
    path = _dir_with(tmp_path, d, [], **{"gpt.pth": {"model": torch.load(d / "gpt.pth")}})
    params, aux = loader.convert_reference_checkpoints(path, pcfg)
    assert set(params) == {"gpt"} and aux == {}
    _assert_same(params["gpt"], converted[2]["gpt"])


@pytest.mark.parametrize("form", ["weight_norm", "folded"])
def test_bigvgan_loads_weight_normed_or_folded(ckpt, converted, tmp_path, form):
    """A weight-normed generator folds to the JAX loader's tensors; a folded
    one loads as it was written, to the bit, as the JAX loader reads it."""
    from indextts_tpu.runtime.loader import convert_reference_checkpoints

    d, cfg, pcfg, sds, _ = ckpt
    (tmp_path / "hf").mkdir()
    if form == "weight_norm":
        os.symlink(d / "hf" / "bigvgan_generator.pt", tmp_path / "hf" / "bigvgan_generator.pt")
        want = converted[0]["bigvgan"]
    else:
        torch.save({"generator": sds["bigvgan"]}, tmp_path / "hf" / "bigvgan_generator.pt")
        want = sds["bigvgan"]
        _assert_same(from_jax_params(
            {**parity_params(cfg, seed=1),
             **convert_reference_checkpoints(str(tmp_path), cfg)[0]}, pcfg)["bigvgan"], want)
    params, _ = loader.convert_reference_checkpoints(str(tmp_path), pcfg)
    assert set(params) == {"bigvgan"}
    _assert_same(params["bigvgan"], want)


def test_keys_the_reference_converter_ignores_are_ignored(ckpt, converted):
    """The files hold a text_head, w2v-BERT layers past tap_layer and its
    masked_spec_embed; the port's state dicts have none of them and load
    into its modules strictly (the engine fixture)."""
    d, cfg, _, _, _ = ckpt
    gpt = torch.load(d / "gpt.pth")
    w2v = load_file(d / "hf" / "w2v-bert-2.0" / "model.safetensors")
    past = f"encoder.layers.{cfg.w2vbert.tap_layer}."
    assert "text_head.weight" in gpt and "masked_spec_embed" in w2v
    assert any(k.startswith(past) for k in w2v)
    params = converted[2]
    assert not any(k.startswith("text_head.") for k in params["gpt"])
    assert not any(k.startswith(past) or k == "masked_spec_embed" for k in params["w2vbert"])


@pytest.mark.parametrize("key", ["text_head.weight", "gpt.h.1.mlp.c_fc.weight"])
def test_missing_key_names_key_and_file(ckpt, tmp_path, key):
    d, _, pcfg, _, _ = ckpt
    sd = torch.load(d / "gpt.pth")
    del sd[key]
    path = _dir_with(tmp_path, d, [], **{"gpt.pth": sd})
    with pytest.raises(KeyError, match=f"gpt.pth: no '{key}'"):
        loader.convert_reference_checkpoints(path, pcfg)


def test_partial_directory_fills_the_rest(ckpt, converted, tmp_path, capsys):
    """Without hf/: GPT and s2mel as loaded, the four others the port's
    random_params(cfg, seed=0), named on stderr; the engine answers."""
    d, _, pcfg, _, _ = ckpt
    path = _dir_with(tmp_path, d, ["gpt.pth", "s2mel.pth", "wav2vec2bert_stats.pt",
                                   "feat1.pt", "feat2.pt"])
    eng = loader.load_engine(path, cfg=pcfg, device="cpu")
    filled = ["bigvgan", "repcodec", "campplus", "w2vbert"]
    assert eng.load_report.filled == filled
    assert f"no checkpoint for {', '.join(filled)}" in capsys.readouterr().err
    rand = random_params(pcfg, seed=0, device="cpu")
    for name in MODELS:
        want = rand[name] if name in filled else converted[2][name]
        _assert_same(getattr(eng, name).state_dict(), want)
    rng = np.random.default_rng(2)
    out = eng.infer((speech_like(rng, 1.0, 16000), 16000), [rng.integers(2, 50, 7)], seed=0)
    assert len(out["audio"]) > 0 and np.isfinite(out["audio"]).all()


ST_CASES = {
    torch.float32: lambda g: torch.randn((3, 5), generator=g),
    torch.float16: lambda g: torch.randn((4, 1, 2), generator=g).half(),
    torch.bfloat16: lambda g: torch.randn((7,), generator=g).bfloat16(),
    torch.int64: lambda g: torch.randint(-2**40, 2**40, (2, 3), generator=g),
}


@pytest.mark.parametrize("dtype", list(ST_CASES), ids=str)
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    """The port's reader gives the bits of safetensors' load_file (numpy's
    too, where numpy has the dtype), with metadata, a scalar and an empty
    tensor beside."""
    import safetensors.numpy
    import safetensors.torch

    g = torch.Generator().manual_seed(0)
    tensors = {"w": ST_CASES[dtype](g), "scalar": ST_CASES[dtype](g).reshape(-1)[0].clone(),
               "empty": ST_CASES[dtype](g)[:0], "bias": torch.randn(5, generator=g)}
    path = tmp_path / "t.safetensors"
    safetensors.torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = load_file(path), safetensors.torch.load_file(str(path))
    _assert_same(got, want)
    if dtype != torch.bfloat16:
        for k, v in safetensors.numpy.load_file(str(path)).items():
            assert np.array_equal(got[k].numpy(), v) and got[k].numpy().dtype == v.dtype


def test_safetensors_package_reads_the_writer(tmp_path):
    """safetensors reads what chip_smoke.py's writer writes, and so does the
    port's reader."""
    import safetensors.torch

    g = torch.Generator().manual_seed(1)
    tensors = {f"t{i}": make(g) for i, make in enumerate(ST_CASES.values())}
    tensors["flag"] = torch.tensor([True, False, True])
    path = tmp_path / "w.safetensors"
    chip_smoke.save_safetensors(path, tensors, metadata={"format": "pt"})
    _assert_same(safetensors.torch.load_file(str(path)), tensors)
    _assert_same(load_file(path), tensors)


def test_safetensors_writer_round_trips_every_dtype(tmp_path):
    """save_file then load_file gives every dtype of the reader's table back
    to the bit, with the metadata; the `safetensors` package reads the same
    tensors and metadata."""
    import safetensors
    import safetensors.torch

    g = torch.Generator().manual_seed(3)
    tensors = {}
    for code, dtype in DTYPES.items():
        if dtype.is_floating_point:
            x = torch.randn((3, 4), generator=g).to(dtype)
        elif dtype is torch.bool:
            x = torch.randint(0, 2, (3, 4), generator=g).bool()
        else:
            info = torch.iinfo(dtype)
            x = torch.randint(info.min, info.max, (3, 4), generator=g, dtype=dtype)
        tensors[code] = x
        tensors[f"{code}.scalar"] = x.reshape(-1)[0].clone()
        tensors[f"{code}.empty"] = x[:0]
    tensors["strided"] = torch.arange(24, dtype=torch.float32).reshape(4, 6)[:, ::2]
    path = tmp_path / "all.safetensors"
    meta = {"format": "pt", "note": "x"}
    save_file(tensors, path, meta)
    got, got_meta = load_file_with_metadata(path)
    _assert_same(got, {k: v.contiguous() for k, v in tensors.items()})
    assert got_meta == meta
    _assert_same(safetensors.torch.load_file(str(path)), got)
    with safetensors.safe_open(str(path), "pt") as f:
        assert f.metadata() == meta


def _linked_dir(d, src, names=None):
    """A directory `d` whose files are links to `src`'s reference files
    (`names`, by default all of them but its caches)."""
    d.mkdir(exist_ok=True)
    for name in names or sorted(os.listdir(src)):
        if name not in ("torch_cache", "jax_cache"):
            os.symlink(src / name, d / name)
    return d


@pytest.fixture
def conversions(monkeypatch):
    """The calls the port's load_engine makes to convert_reference_checkpoints."""
    calls = []
    real = loader.convert_reference_checkpoints

    def counting(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(loader, "convert_reference_checkpoints", counting)
    return calls


def _assert_engine_holds(eng, want, filled=()):
    for name in MODELS:
        if name not in filled:
            _assert_same(getattr(eng, name).state_dict(), want[name])


def test_cache_written_then_read(ckpt, converted, tmp_path, conversions):
    """A first load converts and writes torch_cache/ (a file a model and
    aux.safetensors); a second converts nothing and reads every state dict
    and aux tensor to the bit."""
    d = _linked_dir(tmp_path / "model", ckpt[0])
    pcfg, want, want_aux = ckpt[2], converted[2], converted[3]
    cold = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert conversions == [str(d)] and cold.load_report.cache == "written"
    files = sorted(os.listdir(d / loader.CACHE_DIR))
    assert files == sorted([f"{m}.safetensors" for m in MODELS] + ["aux.safetensors"])
    assert cold.load_report.cache_bytes == sum(
        (d / loader.CACHE_DIR / f).stat().st_size for f in files)
    warm = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert conversions == [str(d)], "a current cache must skip the conversion"
    assert warm.load_report.cache == "read" and warm.load_report.filled == []
    params, aux, nbytes = loader.read_cache(str(d), pcfg)
    assert nbytes == cold.load_report.cache_bytes and set(params) == set(MODELS)
    for name in MODELS:
        _assert_same(params[name], want[name])
    assert set(aux) == set(want_aux)
    for key in ("emo_matrix", "spk_matrix"):
        assert aux[key].dtype == want_aux[key].dtype and np.array_equal(aux[key], want_aux[key])
    for a, w in zip(aux["semantic_stats"], want_aux["semantic_stats"]):
        assert a.dtype == w.dtype and np.array_equal(a, w)
    _assert_engine_holds(warm, want)
    for key in ("emo_matrix", "spk_matrix"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(warm, key), getattr(cold, key)))
    assert torch.equal(warm.semantic_mean, cold.semantic_mean)
    assert torch.equal(warm.semantic_std, cold.semantic_std)


def test_warm_engine_matches_jax_loader(ckpt, engines, conversions):
    """The engine read from the cache (the module's directory, whose cache
    the `engines` fixture wrote) gives the JAX loader's engine's greedy
    codes, mel and waveform at test_engines_match_jax_loader's tolerances."""
    je, _ = engines
    warm = loader.load_engine(str(ckpt[0]), cfg=ckpt[2], device="cpu")
    assert warm.load_report.cache == "read" and conversions == []
    noise = _noise()
    jc, jm, jw, _ = _request(je, 0, noise)
    pc, pm, pw, _ = _request(warm, 0, noise)
    assert len(jc) > 2
    np.testing.assert_array_equal(pc, jc)
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()
    assert np.abs(pw - jw).max() <= 1e-3 * np.abs(jw).max()


def test_cache_off_reads_and_writes_nothing(ckpt, converted, tmp_path, conversions):
    """use_native_cache=False: no torch_cache/ is made, and one that is there
    (here a current one whose GPT file was altered) is not read."""
    d = _linked_dir(tmp_path / "model", ckpt[0])
    pcfg = ckpt[2]
    eng = loader.load_engine(str(d), cfg=pcfg, device="cpu", use_native_cache=False)
    assert not (d / loader.CACHE_DIR).exists() and eng.load_report.cache == "not used"
    loader.load_engine(str(d), cfg=pcfg, device="cpu")
    path = d / loader.CACHE_DIR / "gpt.safetensors"
    sd, meta = load_file_with_metadata(path)
    sd = {k: v + 1 for k, v in sd.items()}
    save_file(sd, path, meta)
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (d / loader.CACHE_DIR).iterdir())
    eng = loader.load_engine(str(d), cfg=pcfg, device="cpu", use_native_cache=False)
    assert conversions == [str(d)] * 3 and eng.load_report.cache == "not used"
    _assert_engine_holds(eng, converted[2])
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in (d / loader.CACHE_DIR).iterdir()) == before


def test_partial_directory_caches_what_it_had(ckpt, converted, tmp_path, conversions,
                                              capsys):
    """Without hf/: the cache holds the GPT, s2mel and aux only; the warm
    load reads them and fills the four others from random_params(cfg,
    seed=0), naming them, as the cold one did."""
    d = _linked_dir(tmp_path / "model", ckpt[0], ["gpt.pth", "s2mel.pth",
                                                 "wav2vec2bert_stats.pt", "feat1.pt",
                                                 "feat2.pt"])
    pcfg = ckpt[2]
    filled = ["bigvgan", "repcodec", "campplus", "w2vbert"]
    cold = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert sorted(os.listdir(d / loader.CACHE_DIR)) == [
        "aux.safetensors", "gpt.safetensors", "s2mel.safetensors"]
    warm = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert conversions == [str(d)] and warm.load_report.cache == "read"
    assert cold.load_report.filled == warm.load_report.filled == filled
    assert capsys.readouterr().err.count(f"no checkpoint for {', '.join(filled)}") == 2
    rand = random_params(pcfg, seed=0, device="cpu")
    _assert_engine_holds(warm, {**converted[2], **{m: rand[m] for m in filled}})


def test_replaced_source_is_converted_again(ckpt, tmp_path, conversions):
    """gpt.pth replaced by other weights (its mtime moved on, whatever the
    clock's resolution): the next load converts again, rewrites the cache
    and holds the new weights; the load after it reads them."""
    d = _linked_dir(tmp_path / "model", ckpt[0])
    pcfg = ckpt[2]
    loader.load_engine(str(d), cfg=pcfg, device="cpu")
    sd = torch.load(d / "gpt.pth")
    key = "gpt.h.0.mlp.c_fc.weight"
    sd[key] = sd[key] * 0.5
    mtime = (d / "gpt.pth").stat().st_mtime_ns
    os.unlink(d / "gpt.pth")
    torch.save(sd, d / "gpt.pth")
    os.utime(d / "gpt.pth", ns=(mtime + 10**9, mtime + 10**9))
    again = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert conversions == [str(d)] * 2 and again.load_report.cache == "written"
    assert torch.equal(again.gpt.state_dict()[key], sd[key])
    warm = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert conversions == [str(d)] * 2 and warm.load_report.cache == "read"
    _assert_same(warm.gpt.state_dict(), again.gpt.state_dict())


@pytest.mark.parametrize("how", ["read_only", "blocked"])
def test_failed_cache_write_is_named_and_the_load_goes_on(ckpt, converted, tmp_path,
                                                         monkeypatch, capsys, how):
    """The write fails: a read-only file system (EROFS from the writer,
    after part of a file was written) or a file where the cache directory
    would go. One stderr line names the path and the error, no cache file
    and no partial file is left, and the engine holds the converted
    weights."""
    d = _linked_dir(tmp_path / "model", ckpt[0])
    if how == "read_only":
        def refuse(tensors, path, metadata=None):
            Path(path).write_bytes(b"partial")
            raise OSError(errno.EROFS, "Read-only file system", str(path))

        monkeypatch.setattr(loader, "save_file", refuse)
    else:
        (d / loader.CACHE_DIR).write_text("not a directory")
    eng = loader.load_engine(str(d), cfg=ckpt[2], device="cpu")
    err = [line for line in capsys.readouterr().err.splitlines() if "cache" in line]
    assert len(err) == 1 and str(d / loader.CACHE_DIR) in err[0]
    assert ("Read-only file system" if how == "read_only" else "File exists") in err[0]
    assert eng.load_report.cache == "not used" and eng.load_report.filled == []
    if how == "read_only":
        assert os.listdir(d / loader.CACHE_DIR) == []
    _assert_engine_holds(eng, converted[2])


def test_jax_and_port_caches_coexist(ckpt, tmp_path, conversions, monkeypatch):
    """The JAX loader writes jax_cache/, the port torch_cache/, in one
    directory; each package then reads its own (no conversion), and neither
    reads the other's: without jax_cache/ the JAX loader converts again
    beside a current torch_cache/, and the port's cache read does not
    change when jax_cache/ goes."""
    from indextts_tpu.runtime import loader as jax_loader

    d = _linked_dir(tmp_path / "model", ckpt[0])
    cfg, pcfg = ckpt[1], ckpt[2]
    jax_calls = []
    real = jax_loader.convert_reference_checkpoints

    def jax_counting(*args, **kwargs):
        jax_calls.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_loader, "convert_reference_checkpoints", jax_counting)
    jax_loader.load_engine(str(d), cfg=cfg)
    loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert (d / "jax_cache" / "params").exists() and (d / loader.CACHE_DIR).is_dir()
    assert len(jax_calls) == 1 and len(conversions) == 1
    jax_loader.load_engine(str(d), cfg=cfg)
    warm = loader.load_engine(str(d), cfg=pcfg, device="cpu")
    assert len(jax_calls) == 1 and len(conversions) == 1
    assert warm.load_report.cache == "read"
    shutil.rmtree(d / "jax_cache")
    assert loader.load_engine(str(d), cfg=pcfg, device="cpu").load_report.cache == "read"
    jax_loader.load_engine(str(d), cfg=cfg)
    assert len(jax_calls) == 2 and len(conversions) == 1


def test_config_yaml_matches_jax_load_config(tmp_path):
    """A directory's config.yaml with the tiny config's gpt and s2mel
    sections: the loader's config is the JAX load_config's, carried over."""
    import yaml

    from indextts_tpu.config import load_config

    cfg = parity_config()
    g, s = cfg.gpt, cfg.s2mel
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({
        "gpt": {**{k: getattr(g, k) for k in (
            "layers", "model_dim", "heads", "max_text_tokens", "max_mel_tokens",
            "number_text_tokens", "number_mel_codes", "start_mel_token", "stop_mel_token")},
                "condition_module": dataclasses.asdict(g.condition_module),
                "emo_condition_module": dataclasses.asdict(g.emo_condition_module)},
        "s2mel": {"style_encoder": {"dim": s.dit.style_dim},
                  "length_regulator": {"channels": s.length_regulator.channels,
                                       "in_channels": s.length_regulator.in_channels,
                                       "sampling_ratios": list(
                                           s.length_regulator.sampling_ratios)},
                  "DiT": {"hidden_dim": s.dit.hidden_dim, "num_heads": s.dit.num_heads,
                          "depth": s.dit.depth, "content_dim": s.dit.content_dim},
                  "wavenet": {"hidden_dim": s.wavenet.hidden_dim,
                              "num_layers": s.wavenet.num_layers}},
    }))
    got = loader.model_config(str(tmp_path))
    assert got == to_port_config(load_config(str(tmp_path / "config.yaml")))
    assert got.gpt == to_port_config(g) and got.s2mel.dit.depth == s.dit.depth
    assert got.s2mel.wavenet.hidden_dim == s.wavenet.hidden_dim


class _Served:
    """serve.build --model-dir on the CPU, its server on an event loop in a
    thread."""

    def __init__(self, model_dir, pcfg, tmp_path, monkeypatch):
        from indextts_tpu_torch import serve
        from indextts_tpu_torch.utils import audio as audio_utils

        monkeypatch.setenv("TARS_CACHE_DIR", str(tmp_path / "cache"))
        monkeypatch.setenv("TARS_PRECOMPILE", "0")
        monkeypatch.setenv("TARS_WARMUP", "0")
        wav = str(tmp_path / "spk.wav")
        audio_utils.save_wav(wav, speech_like(np.random.default_rng(1), 1.0, 16000), 16000)
        self.port = _free_port()
        self.server, self.engine = serve.build(
            ["--host", "127.0.0.1", "--port", str(self.port), "--device", "cpu",
             "--reference-audio", wav, "--model-dir", str(model_dir)], cfg=pcfg)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.fut = asyncio.run_coroutine_threadsafe(self.server.serve(), self.loop)
        t0 = time.time()
        while not self.server.ready:
            assert not self.fut.done() and time.time() - t0 < 30
            time.sleep(0.02)

    def request(self, method, path, payload=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out = (r.status, r.getheader("Content-Type"), r.read())
        conn.close()
        return out

    def close(self):
        self.fut.cancel()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.server.pool.shutdown(wait=True)


def _wav_frames(body) -> int:
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        return w.getnframes()


def test_serve_model_dir_answers_tts(ckpt, converted, tmp_path, monkeypatch):
    """serve.build --model-dir: the loaded engine (its GPT the loaded
    tensors, the bpe.model tokenizer), POST /tts on the infer_text route
    answers a WAV; GET /ui and / give the page; /metrics has no device
    gauge on the CPU."""
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    d, _, pcfg, _, _ = ckpt
    texts = []
    infer_text = IndexTTS2Engine.infer_text

    def spy(self, spk, text, *a, **kw):
        texts.append(text)
        return infer_text(self, spk, text, *a, **kw)

    monkeypatch.setattr(IndexTTS2Engine, "infer_text", spy)
    served = _Served(d, pcfg, tmp_path, monkeypatch)
    try:
        assert served.engine.cfg.runtime.num_beams == 1
        assert served.engine.load_report.filled == [] and served.engine.qwen_emo is None
        _assert_same(served.engine.gpt.state_dict(), converted[2]["gpt"])
        status, ctype, body = served.request("POST", "/tts", {"text": TEXT, "seed": 3})
        assert status == 200 and ctype == "audio/wav", body[:200]
        assert _wav_frames(body) > 0 and texts == [TEXT]
        for path in ("/ui", "/", "/ui?lang=zh_CN"):
            status, ctype, body = served.request("GET", path)
            assert status == 200 and ctype.startswith("text/html"), path
            assert "<h1>IndexTTS" in body.decode() and "/tts" in body.decode()
        assert "合成" in served.request("GET", "/ui?lang=zh_CN")[2].decode()
        status, _, body = served.request("GET", "/metrics")
        assert status == 200 and b"indextts_requests_total 1" in body
        assert b"indextts_hbm_in_use_gb" not in body
    finally:
        served.close()


def test_metrics_gauge_reads_the_cards_allocator(monkeypatch):
    """On an engine on the card, /metrics carries indextts_hbm_in_use_gb,
    the allocator's bytes on that device in GB (the JAX server's name)."""
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer

    asked = []

    def allocated(device):
        asked.append(device)
        return 2_345_600_000

    monkeypatch.setattr(torch.cuda, "memory_allocated", allocated)
    server = TTSServer(lambda **kw: None, ServerSettings(), device=torch.device("cuda", 0))
    try:
        text = server._metrics_text()
    finally:
        server.pool.shutdown()
    assert "# TYPE indextts_hbm_in_use_gb gauge\nindextts_hbm_in_use_gb 2.346\n" in text
    assert asked == [torch.device("cuda", 0)]


def _qwen_dir(qdir):
    """A small Qwen3 checkpoint directory: chip_smoke.QWEN_SMALL-sized
    weights from the JAX Qwen3LM's initialization through weights.qwen3_sd,
    a word-level tokenizer.json and a tokenizer_config.json with a chat
    template (tokenizers and transformers, nothing downloaded)."""
    import jax
    import jax.numpy as jnp
    from tokenizers import Tokenizer, models, pre_tokenizers

    from indextts_tpu.config import QwenEmoConfig as JaxQwenConfig
    from indextts_tpu.models.qwen3 import Qwen3LM as JaxQwen3LM
    from indextts_tpu_torch.config import QwenEmoConfig
    from indextts_tpu_torch.weights import qwen3_sd

    qdir.mkdir()
    jm = JaxQwen3LM(JaxQwenConfig(**chip_smoke.QWEN_SMALL))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32), jnp.arange(4)))
    chip_smoke.save_safetensors(qdir / "model.safetensors",
                                qwen3_sd(params, QwenEmoConfig(**chip_smoke.QWEN_SMALL)))
    special = ["<unk>", "<|im_start|>", "<|im_end|>"]
    vocab = {w: i for i, w in enumerate(
        special + [f"w{i}" for i in range(chip_smoke.QWEN_SMALL["vocab_size"] - len(special))])}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(special[1:])
    tok.save(str(qdir / "tokenizer.json"))
    (qdir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|im_end|>",
        "unk_token": "<unk>",
        "chat_template": "{% for m in messages %}<|im_start|>{{ m['role'] }} {{ m['content'] }}"
                         "<|im_end|>{% endfor %}{% if add_generation_prompt %}<|im_start|>"
                         "assistant{% endif %}"}))


@pytest.mark.parametrize("qwen", ["small", "broken"])
def test_serve_model_dir_attaches_its_qwen(ckpt, tmp_path, monkeypatch, caplog, qwen):
    """A directory with qwen0.6bemo4-merge/: a small Qwen3 there is attached
    and a use_emo_text request answers 200; one that fails to load is
    reported, and the server serves without it (use_emo_text: 400)."""
    from indextts_tpu_torch import config as port_config
    from indextts_tpu_torch.runtime.qwen_emo import QwenEmotion

    d, _, pcfg, _, _ = ckpt
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    for name in os.listdir(d):
        os.symlink(d / name, model_dir / name)
    qdir = model_dir / "qwen0.6bemo4-merge"
    if qwen == "small":
        _qwen_dir(qdir)
        full = port_config.QwenEmoConfig
        monkeypatch.setattr(port_config, "QwenEmoConfig",
                            lambda **kw: full(**{**chip_smoke.QWEN_SMALL, **kw}))
    else:
        qdir.mkdir()
        (qdir / "tokenizer_config.json").write_text("{not json")
    served = _Served(model_dir, pcfg, tmp_path, monkeypatch)
    try:
        status, _, body = served.request("POST", "/tts", {"text": TEXT, "seed": 3,
                                                          "use_emo_text": True})
        if qwen == "small":
            assert isinstance(served.engine.qwen_emo, QwenEmotion)
            assert status == 200 and _wav_frames(body) > 0, body[:200]
        else:
            assert served.engine.qwen_emo is None
            assert "Qwen emotion load failed" in caplog.text
            assert status == 400 and b"qwen_emo" in body
            status, _, body = served.request("POST", "/tts", {"text": TEXT, "seed": 3})
            assert status == 200 and _wav_frames(body) > 0
    finally:
        served.close()
    shutil.rmtree(model_dir)

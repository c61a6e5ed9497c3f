"""The port's native host DSP (indextts_tpu_torch/utils/native.py over its
copy of csrc/dsp.cpp) against the JAX package's and against numpy, on the
CPU.

* kaldi fbank: equal to the JAX package's native fbank within 1e-6, within
  1e-4 of the numpy `kaldi_fbank_core`; no frames from a short input.
* The resampler within 1e-6 of scipy's resample_poly, edges included, at
  the engine's rates (the port's copy designs scipy's FIR; the JAX
  library's differs from it by up to ~5e-3); float_to_pcm16 and
  pcm16_to_float bit-equal to the JAX library's.
* INDEXTTS_NATIVE_DSP: unset or "1" takes the native fbank and PCM16 and
  scipy's resampler, "all" the native resampler too, "0" numpy for all
  three; the answers agree across modes.
* A source that does not compile raises with the compiler's output (no
  fallback); threads that build at once all load the one library.
"""

import threading

import numpy as np
import pytest

from indextts_tpu_torch.frontend import features as F
from indextts_tpu_torch.utils import audio as A
from indextts_tpu_torch.utils import native


@pytest.fixture(scope="module")
def jax_native():
    from indextts_tpu.utils import native as jn

    assert jn.available(), "the JAX package's native library did not build"
    return jn


def _wav(seed: int, n: int = 16000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


@pytest.mark.parametrize("mel_floor,scale,n", [(1.192092955078125e-07, 1.0, 16000),
                                               (1.1920928955078125e-07, 1.0, 16000),
                                               (1.192092955078125e-07, 2.0 ** 15, 48000)])
def test_fbank_matches_jax_native_and_numpy(jax_native, mel_floor, scale, n):
    """The third case is seamless_features' input: a 3-s prompt in PCM16
    units, log-mels up to ~30, where 1e-6 is below a float32 step."""
    wav = _wav(0, n) * np.float32(scale)
    got = native.kaldi_fbank(wav, mel_floor=mel_floor)
    want = jax_native.kaldi_fbank(wav, mel_floor=mel_floor)
    assert got.shape == want.shape == (1 + (n - 400) // 160, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, F.kaldi_fbank_core(wav, mel_floor=mel_floor),
                               rtol=1e-4, atol=1e-4)
    assert native.kaldi_fbank(np.zeros(100, np.float32)).shape == (0, 80)
    with pytest.raises(ValueError):
        native.kaldi_fbank(wav, fft_length=384)


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 22050), (24000, 16000), (24000, 22050),
                                          (44100, 16000)])
def test_resample_close_to_scipy(sr_in, sr_out):
    from scipy.signal import resample_poly

    rng = np.random.default_rng(sr_in + sr_out)
    t = np.arange(sr_in) / sr_in
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(sr_in))
    x = x.astype(np.float32)
    g = np.gcd(sr_in, sr_out)
    got = native.resample(x, sr_in, sr_out)
    want = resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)
    assert len(got) == len(want) == sr_out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(native.resample(x, sr_in, sr_in), x)


def test_pcm16_bitequal_to_jax(jax_native):
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001), [0.0, 0.5, -0.5, 2.0, -2.0]])
    x = x.astype(np.float32)
    got = native.float_to_pcm16(x)
    np.testing.assert_array_equal(got, jax_native.float_to_pcm16(x))
    assert got[-2] == 32767 and got[-1] == -32767
    ints = np.arange(-32768, 32768, 7, dtype=np.int16)
    want = np.empty(len(ints), np.float32)
    jax_native.get_lib().pcm16_to_float(ints, len(ints), want)
    np.testing.assert_array_equal(native.pcm16_to_float(ints), want)
    np.testing.assert_array_equal(want, ints.astype(np.float32) / 32768.0)


def _spy(monkeypatch, name, calls):
    orig = getattr(native, name)
    monkeypatch.setattr(native, name, lambda *a, **k: calls.append(name) or orig(*a, **k))


@pytest.mark.parametrize("mode", [None, "1", "all", "0"])
def test_dispatch_follows_the_switch(monkeypatch, mode):
    """Which of fbank, PCM16 and the resampler go native under each value
    of INDEXTTS_NATIVE_DSP, as in the JAX package, and the same answers
    (fbank within 2e-4, PCM16 bit-equal, a tone resampled within 1e-6)."""
    calls = []
    for name in ("kaldi_fbank", "float_to_pcm16", "resample"):
        _spy(monkeypatch, name, calls)
    monkeypatch.delenv("INDEXTTS_NATIVE_DSP", raising=False)
    if mode is not None:
        monkeypatch.setenv("INDEXTTS_NATIVE_DSP", mode)
    wav = _wav(1)
    feats, mask = F.seamless_features(wav)
    camp = F.campplus_fbank(wav)
    pcm = np.frombuffer(A.pcm16_bytes(np.linspace(-1.2, 1.2, 1000).astype(np.float32)),
                        np.int16)
    tone = (0.5 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000.0)).astype(np.float32)
    up = A.resample(tone, 16000, 22050)
    want = {None: ["kaldi_fbank", "kaldi_fbank", "float_to_pcm16"],
            "1": ["kaldi_fbank", "kaldi_fbank", "float_to_pcm16"],
            "all": ["kaldi_fbank", "kaldi_fbank", "float_to_pcm16", "resample"],
            "0": []}[mode]
    assert calls == want
    monkeypatch.setenv("INDEXTTS_NATIVE_DSP", "0")
    f0, m0 = F.seamless_features(wav)
    np.testing.assert_array_equal(mask, m0)
    np.testing.assert_allclose(feats, f0, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(camp, F.campplus_fbank(wav), rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(
        pcm, np.frombuffer(A.pcm16_bytes(np.linspace(-1.2, 1.2, 1000).astype(np.float32)),
                           np.int16))
    up0 = A.resample(tone, 16000, 22050)
    assert up.shape == up0.shape
    np.testing.assert_allclose(up, up0, rtol=0, atol=1e-6)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile: the fbank raises with g++'s message,
    under the default switch; numpy is not taken in its place."""
    bad = tmp_path / "dsp.cpp"
    bad.write_text("int kaldi_fbank( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("INDEXTTS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("INDEXTTS_NATIVE_DSP", raising=False)
    with pytest.raises(RuntimeError, match="native DSP build failed(.|\n)*error"):
        F.campplus_fbank(_wav(2))
    assert list((tmp_path / "build").iterdir()) == []  # nothing half-written left
    # a library that does not load raises too
    monkeypatch.setattr(native, "SOURCE", tmp_path / "dsp_ok.cpp")
    native.SOURCE.write_text("extern \"C\" int f() { return 0; }\n")
    native.so_path().write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="failed to load"):
        native.lib()


def test_builds_at_once_share_one_library(monkeypatch, tmp_path):
    """Four threads build into an empty directory at once: each writes its
    own file and renames it into place; every one returns the same path,
    which loads, and no temporary file is left."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("INDEXTTS_TORCH_BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def run():
        try:
            paths.append(native.build())
        except RuntimeError as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and errors == []
    assert len(set(paths)) == 1 and [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    np.testing.assert_array_equal(native.float_to_pcm16(np.array([0.5], np.float32)),
                                  [16383])

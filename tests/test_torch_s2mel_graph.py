"""The port's bucketed s2mel stage (`precise_shapes=False`, the default) on
the CPU, where the CFM solve runs eagerly (on the card it is a replay of a
captured graph: tests/test_torch_cuda.py).

* The port bucketed against the JAX engine bucketed, from the same
  parameters, speaker audio, text ids and CFM noise hook, greedy with one
  beam: equal codes, mel within 1e-4 of its largest value (the tolerance of
  tests/test_torch_slice.py).
* The port bucketed against the port precise, the noise drawn from the
  request's seed: the noise is drawn at the bucket's width in both modes, so
  each frame gets the same noise, and the padding is masked, so the mels
  agree to float32 tolerance (1e-5 of the largest value: a wider buffer
  changes the shapes CPU BLAS blocks its sums by); the waveforms up to the
  tail that the vocoder's receptive field reaches into the padding.
* `next_bucket` and the DiT's RoPE rows are the JAX package's.
"""

import numpy as np
import pytest
import torch

from indextts_tpu_torch.runtime.engine import next_bucket
from indextts_tpu_torch.weights import from_jax_params
from test_torch_slice import _capture_codes
from torch_parity import parity_config, parity_params, speech_like, to_port_config


@pytest.fixture(scope="module")
def setup():
    cfg = parity_config()
    return cfg, parity_params(cfg, seed=1)


def _port(cfg, jp, **kw):
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine

    pcfg = to_port_config(cfg)
    return IndexTTS2Engine(pcfg, from_jax_params(jp, pcfg), device="cpu", **kw)


def _inputs():
    rng = np.random.default_rng(0)
    return speech_like(rng, 1.2, 16000), rng.integers(2, 50, 9)


def _request(eng, seed, noise=None):
    """One greedy request; returns (codes, mel, waveform, noise shapes)."""
    prompt, text = _inputs()
    shapes, codes = [], []
    if noise is not None:
        def hook(shape):
            shapes.append(shape)
            return noise(shape)

        eng._noise_hook = hook
    eng._mel_taps = []
    _capture_codes(eng, codes)
    res = eng.infer((prompt, 16000), [text], seed=seed, num_beams=1, do_sample=False)
    return codes[0], eng._mel_taps[0], res["audio"], shapes


def test_bucketed_matches_jax_bucketed(setup):
    """Both engines at their default, precise_shapes=False: the hook sees
    the same bucketed shape (prompt frames + a multiple of 128), the codes
    are equal and the exact-length mels agree."""
    from indextts_tpu.runtime.engine import IndexTTS2Engine as JaxEngine

    cfg, jp = setup
    noises, noise_rng = {}, np.random.default_rng(5)

    def noise(shape):
        if shape not in noises:
            noises[shape] = noise_rng.standard_normal(shape).astype(np.float32)
        return noises[shape]

    jc, jm, jw, jshapes = _request(JaxEngine(cfg, jp), 0, noise)
    pe = _port(cfg, jp)
    assert not pe.precise
    pc, pm, pw, pshapes = _request(pe, 0, noise)
    assert len(jc) > 2
    np.testing.assert_array_equal(pc, jc)
    ref_len = pe.prepare_speaker(_inputs()[0], 16000).ref_mel_len
    exact = jm.shape[2]
    assert exact % 128  # the solve ran on padding
    assert pshapes == jshapes == [(1, 80, ref_len + next_bucket(exact, 128, 128))]
    assert pm.shape == jm.shape and pw.shape == jw.shape
    assert np.abs(pm - jm).max() <= 1e-4 * np.abs(jm).max()


def test_bucketed_matches_precise(setup):
    """The port bucketed and precise, noise drawn from the same seed (no
    hook): the same codes and mel length; mels within 1e-5 of the largest
    value; waveforms within 1e-4 of the peak up to the last 10 frames'
    samples, where the bucketed vocoder's receptive field reaches the
    bucket's log(1e-5) padding and the precise one's the buffer's edge
    (tests/test_engine_precise.py measures the gap from ~2.5 frames before
    the end; tests/test_torch_tail_buckets.py holds the tail to the JAX
    engine's)."""
    cfg, jp = setup
    bc, bm, bw, _ = _request(_port(cfg, jp), 3)
    pc, pm, pw, _ = _request(_port(cfg, jp, precise_shapes=True), 3)
    np.testing.assert_array_equal(bc, pc)
    assert bm.shape == pm.shape and bw.shape == pw.shape
    assert np.abs(bm - pm).max() <= 1e-5 * np.abs(pm).max()
    assert 0 < np.abs(pw).max() < 1.0
    body = len(pw) - 10 * cfg.vocoder.total_upsample
    assert body > 2000  # a non-trivial body is compared
    assert np.abs(bw[:body] - pw[:body]).max() <= 1e-4 * np.abs(pw).max()


def test_next_bucket_matches_jax():
    from indextts_tpu.runtime.engine import next_bucket as jax_next_bucket

    for step, minimum in ((128, 128), (64, 64), (16, 0), (7, 3)):
        for n in range(0, 1100):
            assert next_bucket(n, step, minimum) == jax_next_bucket(n, step, minimum)


def test_dit_rope_rows_are_the_tables(setup):
    """The DiT's RoPE rows [0, T) are a view of one table on the device, made
    once, equal to the JAX package's table rows."""
    from indextts_tpu.models.s2mel import precompute_rope as jax_rope

    cfg, jp = setup
    dit = _port(cfg, jp).s2mel.cfm.estimator.transformer
    c = cfg.s2mel.dit
    want = jax_rope(c.rope_table_size, c.head_dim, c.rope_base)
    for T in (1, 37, 300):
        got = dit.rope(T, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want[:T])
    cpu = torch.device("cpu")
    assert dit.rope(5, cpu).data_ptr() == dit.rope(9, cpu).data_ptr()

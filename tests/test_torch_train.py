"""The port's training path (indextts_tpu_torch/runtime/train.py,
indextts_tpu_torch/finetune.py) against the JAX package's
(indextts_tpu/runtime/train.py), on the CPU at the tiny config.

Both sides get the same numpy parameters (tests/torch_parity.py, with a
seeded text_head added to the GPT tree) and the same numpy-seeded batches,
CFM times, noise and CFG drops. The JAX DiT attention takes its XLA path on
the CPU, as the JAX package's own tests run it; the port's
`dit_attention_train` takes, on CPU tensors, `dit_attention_plain` and
autograd through it. JAX gradient trees are carried into the port's
layout by weights.py's converters (transposes only).

Tolerances: float32 on both sides, summed in other orders. Losses within
1e-5 relative; logits and y_flow within 1e-5 of their largest |value|;
each parameter's gradient within 1e-4 of its largest |value| (tiny
gradients are a sum of float32 terms that cancel). After three AdamW
steps each parameter's distance from the JAX one (2-norm) within 1e-2 of
the JAX update's norm plus 1e-6 a element: Adam divides each element by
its gradient's root mean square, so an element whose gradient is tiny
against the rest of its tensor, and so mostly rounding, moves up to ~lr a
step on either side (measured: at most 0.23 lr in one element, 1.7e-3 of
the update's norm, WaveNet's last in_layer; the decayed-only parameters
differ by float32 rounding, ~1e-7). The GPT's key bias has a gradient that
is zero in exact arithmetic, so it is held only to three Adam steps.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from indextts_tpu.models.s2mel import S2Mel as JaxS2Mel
from indextts_tpu.models.unified_voice import UnifiedVoice as JaxUnifiedVoice
from indextts_tpu.runtime import train as jax_train
from indextts_tpu_torch import finetune
from indextts_tpu_torch import weights
from indextts_tpu_torch.ops import dit_attention as k3
from indextts_tpu_torch.runtime import train
from indextts_tpu_torch.runtime.loader import convert_reference_checkpoints
from torch_parity import n, parity_config, parity_params, t, to_port_config, write_checkpoint_dir

LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=0)
    rng = np.random.default_rng(20)
    g = cfg.gpt
    a = np.sqrt(3.0 / g.model_dim)
    jp["gpt"]["text_head"] = {
        "kernel": rng.uniform(-a, a, (g.model_dim, g.number_text_tokens + 1)).astype(np.float32),
        "bias": rng.uniform(-0.1, 0.1, g.number_text_tokens + 1).astype(np.float32)}
    jp = jax.tree_util.tree_map(np.asarray, jp)
    sds = weights.from_jax_params(jp, pcfg, text_head=True)
    return cfg, pcfg, jp, sds


def gpt_batch(cfg, seed: int, B: int = 2):
    return finetune.synthetic_gpt_batch(cfg, B, np.random.default_rng(seed))


def cfm_batch(cfg, seed: int, B: int = 3, T: int = 40):
    rng = np.random.default_rng(seed)
    d = cfg.s2mel.dit
    return {
        "x1": rng.standard_normal((B, d.in_channels, T)).astype(np.float32),
        "x_lens": np.array([T, T - 7, T - 13][:B], np.int32),
        "prompt_lens": np.array([5, 9, 4][:B], np.int32),
        "mu": rng.standard_normal((B, T, d.content_dim)).astype(np.float32),
        "style": rng.standard_normal((B, d.style_dim)).astype(np.float32),
    }


def cfm_noise(batch, seed: int):
    """t, z and a CFG drop (one row of three dropped) from numpy."""
    rng = np.random.default_rng(seed)
    B = batch["x1"].shape[0]
    return (rng.uniform(0, 1, B).astype(np.float32),
            rng.standard_normal(batch["x1"].shape).astype(np.float32),
            np.arange(B) == 1)


def port_batch(batch):
    return finetune.to_device(batch, torch.device("cpu"))


def assert_close_rel(got, want, rel, what):
    got, want = n(got), np.asarray(want)
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * top, f"{what}: {err} > {rel} x {top}"


def assert_grads(model, jax_grads, convert, rel=1e-4):
    """Each parameter's gradient against the JAX gradient tree carried into
    the port's layout; a parameter the loss does not reach has no gradient
    (zeros in the tree)."""
    want = convert(jax.tree_util.tree_map(np.asarray, jax_grads))
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = n(want[name])
        if p.grad is None:
            assert not np.any(w), f"{name}: no gradient in the port, {np.abs(w).max()} in JAX"
        else:
            assert_close_rel(p.grad, w, rel, name)


def test_cfm_loss_and_gradients_match_jax(setup):
    cfg, pcfg, jp, sds = setup
    batch = cfm_batch(cfg, 1)
    tt, z, drop = cfm_noise(batch, 2)
    jmodel = JaxS2Mel(cfg.s2mel)

    def loss_fn(p):
        return jax_train.cfm_loss(jmodel, {"params": p}, *(jnp.asarray(batch[k]) for k in (
            "x1", "x_lens", "prompt_lens", "mu", "style")), jnp.asarray(tt), jnp.asarray(z),
            jnp.asarray(drop))

    (jloss, jflow), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp["s2mel"])
    model = train.train_model(pcfg, "cfm", "cpu", sds["s2mel"])
    b = port_batch(batch)
    loss, flow = train.cfm_loss(model, b["x1"], b["x_lens"], b["prompt_lens"], b["mu"],
                                b["style"], t(tt), t(z), t(drop))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_close_rel(flow, jflow, 1e-5, "y_flow")
    assert_grads(model, jgrads, lambda g: weights.s2mel_sd(g, pcfg))


def test_cfm_drop_cond_zeroes_the_condition(setup):
    """A dropped row's velocity does not depend on its prompt, condition or
    style; a kept row's does."""
    cfg, pcfg, _, sds = setup
    model = train.train_model(pcfg, "cfm", "cpu", sds["s2mel"])
    b = port_batch(cfm_batch(cfg, 3))
    x, tt = b["x1"], torch.full((3,), 0.5)
    drop = torch.tensor([True, False, True])
    with torch.no_grad():
        one = model.velocity(x, x, b["x_lens"], tt, b["style"], b["mu"], drop)
        two = model.velocity(x, 2 * x, b["x_lens"], tt, -b["style"], 3 * b["mu"], drop)
    assert torch.equal(one[drop], two[drop])
    assert not torch.allclose(one[~drop], two[~drop])


def test_forward_train_and_mel_text_loss_gradients_match_jax(setup):
    cfg, pcfg, jp, sds = setup
    batch = gpt_batch(cfg, 4)
    jmodel = JaxUnifiedVoice(cfg.gpt)
    args = [jnp.asarray(batch[k]) for k in ("spk_latents", "text_ids", "text_lens",
                                             "mel_codes", "mel_lens", "emovec")]
    jout = jax.jit(lambda p: jmodel.apply({"params": p}, *args,
                                          method=JaxUnifiedVoice.forward_train))(jp["gpt"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.mel_text_loss(jmodel, {"params": p}, *args)))(jp["gpt"])
    model = train.train_model(pcfg, "gpt", "cpu", sds["gpt"])
    b = port_batch(batch)
    pargs = [b[k] for k in ("spk_latents", "text_ids", "text_lens", "mel_codes", "mel_lens",
                            "emovec")]
    with torch.no_grad():
        out = model.forward_train(*pargs)
    for what, got, want in zip(("text logits", "mel logits"), out[:2], jout[:2]):
        assert got.shape == want.shape
        assert_close_rel(got, want, 1e-5, what)
    for got, want in zip(out[2:], jout[2:]):
        np.testing.assert_array_equal(n(got), np.asarray(want))
    loss = train.mel_text_loss(model, *pargs)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert_grads(model, jgrads, lambda g: weights.unified_voice_sd(g, pcfg, text_head=True))


def jax_masked_attention(q, k, v, mask):
    """indextts_tpu/models/s2mel.py DiTAttention's XLA path (its lines
    132-136), over (B, H, T, Dh) and a (B, T) key mask."""
    scores = jnp.einsum("bhtd,bhsd->bhts", q, k) / np.sqrt(q.shape[-1])
    scores = jnp.where(mask[:, None, None, :], scores, k3.NEG_INF)
    probs = jax.nn.softmax(scores.astype(jnp.float32), axis=-1).astype(v.dtype)
    return jnp.einsum("bhts,bhsd->bhtd", probs, v)


@pytest.mark.parametrize("dh,T", [pytest.param(8, 19, id="8"), pytest.param(64, 19, id="64"),
                                  pytest.param(8, 130, id="8-T130"),
                                  pytest.param(64, 130, id="64-T130")])
def test_attention_function_gradients_match_jax(dh, T):
    """dit_attention_train on CPU tensors (the plain version, autograd
    through it) against jax.grad of the JAX masked attention: a full row, a
    row of one valid key and a row of none (uniform softmax: dV but no dQ,
    dK). T=130 crosses K9's and K10's tiles (64 and 32 rows) and adds a row
    whose valid keys are no prefix: keys 64-127, a whole tile of each,
    masked between valid keys, every seventh key elsewhere too."""
    j = np.arange(T)
    rows = [j < T, j < 1, j < 0]
    if T > 128:
        rows.append(~(((j >= 64) & (j < 128)) | (j % 7 == 3)))
    mask = np.stack(rows)
    rng = np.random.default_rng(dh)
    q, k, v, dout = (rng.standard_normal((len(rows), 2, T, dh)).astype(np.float32)
                     for _ in range(4))
    jout, vjp = jax.vjp(lambda a, b, c: jax_masked_attention(a, b, c, jnp.asarray(mask)),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(dout))
    qkv = [t(x).requires_grad_(True) for x in (q, k, v)]
    out = k3.dit_attention_train(*qkv, t(mask))
    out.backward(t(dout))
    assert_close_rel(out, jout, 1e-6, "out")
    for name, x, want in zip("qkv", qkv, jgrads):
        assert_close_rel(x.grad, want, 1e-5, f"d{name}")
    assert not qkv[0].grad[2].any() and not qkv[1].grad[2].any() and qkv[2].grad[2].abs().max() > 0
    for r in np.flatnonzero(mask.any(1)):  # a masked key of a row with a valid key: no gradient
        assert not qkv[1].grad[r][:, ~mask[r]].any() and not qkv[2].grad[r][:, ~mask[r]].any()


def test_attention_function_refuses_bfloat16_training():
    q = torch.randn((1, 2, 5, 8), dtype=torch.bfloat16, requires_grad=True)
    mask = torch.ones((1, 5), dtype=torch.bool)
    with pytest.raises(TypeError, match="trains in float32"):
        k3.dit_attention_train(q, q.detach(), q.detach(), mask)
    with torch.no_grad():  # serving: no grad, the plain version
        assert k3.dit_attention_train(q, q, q, mask).dtype == torch.bfloat16


def _params_after_jax_steps(target, cfg, jp, batches, noises):
    opt = optax.adamw(LR)
    if target == "gpt":
        model = JaxUnifiedVoice(cfg.gpt)
        step = jax.jit(jax_train.make_train_step(model, opt))
        params = {"params": jp["gpt"]}
    else:
        model = JaxS2Mel(cfg.s2mel)
        params = {"params": jp["s2mel"]}

        @jax.jit
        def step(p, o, b, noise):
            # make_cfm_train_step's update with its random draws given
            def loss_fn(pp):
                return jax_train.cfm_loss(model, pp, b["x1"], b["x_lens"], b["prompt_lens"],
                                          b["mu"], b["style"], *noise)[0]

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o = opt.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss

    state = opt.init(params)
    losses = []
    for i, batch in enumerate(batches):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        if target == "gpt":
            params, state, loss = step(params, state, b)
        else:
            params, state, loss = step(params, state, b,
                                       tuple(jnp.asarray(x) for x in noises[i]))
        losses.append(float(loss))
    return jax.tree_util.tree_map(np.asarray, params["params"]), losses


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_three_adamw_steps_match_jax(setup, target):
    """Three steps of make_train_step / make_cfm_train_step with
    adamw(lr) against the JAX steps with optax.adamw(lr), on three
    batches; every parameter, the ones the loss does not reach (decayed
    only) included."""
    cfg, pcfg, jp, sds = setup
    make = gpt_batch if target == "gpt" else cfm_batch
    batches = [make(cfg, 10 + i) for i in range(3)]
    noises = [cfm_noise(b, 20 + i) for i, b in enumerate(batches)] if target == "cfm" else []
    want, jlosses = _params_after_jax_steps(target, cfg, jp, batches, noises)
    model = train.train_model(pcfg, target, "cpu", sds["gpt" if target == "gpt" else "s2mel"])
    opt = train.adamw(model.parameters(), LR)
    losses = []
    if target == "gpt":
        step = train.make_train_step(model, opt)
        for b in batches:
            losses.append(step(port_batch(b)).item())
        want = weights.unified_voice_sd(want, pcfg, text_head=True)
    else:
        step = train.make_cfm_train_step(model, opt)
        for b, noise in zip(batches, noises):
            losses.append(step(port_batch(b), noise=tuple(t(x) for x in noise)).item())
        want = weights.s2mel_sd(want, pcfg)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = model.state_dict()
    assert set(got) >= set(want)
    start = sds["gpt" if target == "gpt" else "s2mel"]
    D = cfg.gpt.model_dim
    for name, w in want.items():
        got_p, w0 = got[name], start[name]
        if name.endswith("attn.c_attn.bias"):
            # the key bias: its gradient is zero in exact arithmetic (a
            # constant added to every key leaves the softmax as it is), so
            # Adam moves it by float32 noise over its own root mean square,
            # up to lr a step on either side
            assert float((got_p[D:2 * D] - w0[D:2 * D]).abs().max()) <= 3 * LR * 1.001, name
            got_p, w, w0 = (torch.cat([x[:D], x[2 * D:]]) for x in (got_p, w, w0))
        err = float((got_p - w).norm())
        assert err <= 1e-2 * float((w - w0).norm()) + 1e-6 * w.numel() ** 0.5, (
            f"{name}: {err} against an update of {float((w - w0).norm())}")


def test_cfm_step_draws_from_its_generator(setup):
    """The same generator seed gives the same step; the draw is t, z, drop
    in that order."""
    cfg, pcfg, _, sds = setup
    b = port_batch(cfm_batch(cfg, 5))
    losses = []
    for _ in range(2):
        model = train.train_model(pcfg, "cfm", "cpu", sds["s2mel"])
        step = train.make_cfm_train_step(model, train.adamw(model.parameters(), LR))
        losses.append(step(b, torch.Generator().manual_seed(7)).item())
    tt, z, drop = train.cfm_noise(b, torch.Generator().manual_seed(7))
    model = train.train_model(pcfg, "cfm", "cpu", sds["s2mel"])
    want = train.cfm_loss(model, b["x1"], b["x_lens"], b["prompt_lens"], b["mu"], b["style"],
                          tt, z, drop)[0].item()
    assert losses[0] == losses[1] == want


@pytest.fixture
def tiny_finetune(monkeypatch, setup):
    monkeypatch.setattr(finetune, "load_config", lambda *a, **k: setup[1])


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_finetune_save_and_resume(tiny_finetune, tmp_path, target):
    """As tests/test_finetune_tool.py for tools/finetune.py: steps, a save
    every step, and a resume that continues the step counter from the
    saved parameters and optimizer state."""
    ft = tmp_path / "ft"
    common = ["--device", "cpu", "--target", target, "--synthetic", "2", "--out-dir", str(ft)]
    out = finetune.main(common + ["--steps", "2", "--save-every", "1", "--log-every", "1"])
    assert (out["from_step"], out["final_step"], out["batch"]) == (0, 2, 2)
    assert out["mesh"] == {"data": 1, "model": 1}
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    latest = ft / "latest"
    assert json.loads((latest / "meta.json").read_text())["step"] == 2
    saved = torch.load(latest / "params.pt")
    opt_state = torch.load(latest / "opt_state.pt")
    assert all(s["step"] == 2 for s in opt_state["state"].values())
    out2 = finetune.main(common + ["--steps", "1", "--save-every", "100"])
    assert (out2["from_step"], out2["final_step"]) == (2, 3)
    assert json.loads((latest / "meta.json").read_text())["step"] == 3
    resumed = torch.load(latest / "params.pt")
    assert any(not torch.equal(saved[k], resumed[k]) for k in saved)
    assert all(s["step"] == 3 for s in torch.load(latest / "opt_state.pt")["state"].values())


def test_finetune_init_from_a_reference_directory(tiny_finetune, setup, tmp_path):
    """--init-from reads gpt.pth through the port's loader with its
    text_head, which the first step starts from."""
    cfg, pcfg, _, _ = setup
    write_checkpoint_dir(tmp_path / "ckpt", cfg, parity_params(cfg, seed=1))
    args = finetune.parse_args(["--init-from", str(tmp_path / "ckpt"), "--target", "gpt"])
    state = finetune.initial_state(args, pcfg)
    head = torch.load(tmp_path / "ckpt" / "gpt.pth")["text_head.weight"]
    assert torch.equal(state["text_head.weight"], head)
    out = finetune.main(["--device", "cpu", "--init-from", str(tmp_path / "ckpt"),
                         "--synthetic", "2", "--steps", "1"])
    assert np.isfinite(out["loss_last"])


def test_finetune_refuses_model_parallel_and_a_missing_card(tiny_finetune):
    with pytest.raises(NotImplementedError, match="parallel/"):
        finetune.main(["--device", "cpu", "--model-parallel", "2", "--steps", "1"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError):
        finetune.main(["--synthetic", "2", "--steps", "1"])


def test_loader_keeps_text_head_for_a_training_model(setup, tmp_path):
    """A training model's GPT state dict keeps gpt.pth's text_head, the bits
    of the JAX converter's (its convert_unified_voice, through
    weights.from_jax_params with text_head); a serving model's drops it."""
    from indextts_tpu.runtime.torch_convert import convert_unified_voice
    from indextts_tpu.runtime.torch_convert import to_numpy_sd as jax_to_numpy_sd

    cfg, pcfg, _, _ = setup
    write_checkpoint_dir(tmp_path, cfg, parity_params(cfg, seed=1))
    trained, _ = convert_reference_checkpoints(str(tmp_path), pcfg, text_head=True)
    served, _ = convert_reference_checkpoints(str(tmp_path), pcfg)
    assert set(trained["gpt"]) - set(served["gpt"]) == {"text_head.weight", "text_head.bias"}
    jtree = convert_unified_voice(jax_to_numpy_sd(torch.load(tmp_path / "gpt.pth")), cfg.gpt)
    want = weights.unified_voice_sd(jtree, pcfg, text_head=True)
    for key in ("text_head.weight", "text_head.bias"):
        assert torch.equal(trained["gpt"][key], want[key])
    # the training model loads it strictly
    train.train_model(pcfg, "gpt", "cpu", trained["gpt"])

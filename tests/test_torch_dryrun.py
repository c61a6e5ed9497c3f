"""The port's (data, model) dryrun (indextts_tpu_torch/parallel/dryrun.py)
against the JAX package's __graft_entry__.dryrun_multichip, on the CPU over
gloo:

* the dryrun at N = 2 (mesh (1, 2)) and N = 4 (mesh (2, 2)): every rank
  passes all three parts (a GPT step within 1e-5 relative of the
  one-process step, a TP decode token-equal to the unsharded one, the
  cascade's codes equal and its waveform within 2e-4 x peak of the
  unsharded cascade's), on the mesh JAX picks, and the ranks agree;
* the cascade's configuration is `_dryrun_sharded_cascade`'s (its JAX
  config tree carried over), and the port's unsharded cascade
  (`run_cascade`) on JAX parameters carried across by weights.py, from the
  same inputs, gives the JAX modules' codes and their waveform within 1e-3
  of its peak (the tail's tolerance, tests/test_torch_tail_buckets.py);
  also with every attention head 64 wide, the widths the dryrun takes on
  the card. The parameters are torch_parity's `parity_params` (JAX
  random_params remapped to zero-mean fan-in scaled draws, the vocoder's
  last conv scaled down): JAX random_params' all-positive fill gives every
  row the same codes and clips the waveform, where the comparison would say
  little.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from indextts_tpu_torch.parallel import dryrun
from indextts_tpu_torch.weights import from_jax_params
from torch_parity import parity_params, to_port_config


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_passes_on_its_mesh(n):
    results = dryrun.dryrun_multichip(n, "cpu", log=lambda line: None)
    mesh = [1, 2] if n == 2 else [2, 2]
    assert sorted(r["rank"] for r in results) == list(range(n))
    for r in results:
        assert r["mesh"] == mesh and r["backend"] == "gloo" and r["head_dim"] is None
        assert all(r[part]["ok"] for part in ("train", "decode", "cascade"))
        assert math.isfinite(r["train"]["loss"]) and r["train"]["rel"] <= 1e-5
        assert r["cascade"]["codes_equal"] and r["cascade"]["max_rel"] <= 2e-4
        # the decode cache holds this rank's heads: 10 of 20, 16 wide
        assert r["decode"]["k1_shape"][1:] == [10, r["decode"]["k1_shape"][2], 16]
        assert r["cascade"]["k3_shape"][1:] == [2, 25, 8]
        # the CPU runs the kernels' plain versions, which count nothing
        assert set(r["cascade"]["launches"].values()) == {0}
    for key in ("loss",):
        assert len({r["train"][key] for r in results}) == 1
    assert len({str(r["decode"]["codes"]) for r in results}) == 1


def jax_cascade_config(head_dim=None):
    """__graft_entry__._dryrun_sharded_cascade's config tree (with every
    attention head `head_dim` wide where given)."""
    from indextts_tpu.config import (
        BigVGANConfig,
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

    gpt_dim, dit_dim = (64, 32) if head_dim is None else (4 * head_dim, 4 * head_dim)
    return IndexTTS2Config(
        gpt=GPTConfig(
            model_dim=gpt_dim, layers=2, heads=4, max_mel_tokens=64,
            max_text_tokens=32, number_text_tokens=50, number_mel_codes=36,
            start_mel_token=34, stop_mel_token=35,
            condition_module=ConditionModuleConfig(
                output_size=32, linear_units=48, attention_heads=4, num_blocks=1),
            emo_condition_module=ConditionModuleConfig(
                output_size=32, linear_units=32, attention_heads=2, num_blocks=1)),
        semantic_codec=SemanticCodecConfig(
            codebook_size=36, hidden_size=1024, codebook_dim=8, vocos_dim=24,
            vocos_intermediate_dim=32, vocos_num_layers=1),
        s2mel=S2MelConfig(
            length_regulator=LengthRegulatorConfig(channels=32, in_channels=1024),
            dit=DiTConfig(hidden_dim=dit_dim, num_heads=4, depth=2, in_channels=80,
                          content_dim=32, style_dim=192),
            wavenet=WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
            gpt_dims=(gpt_dim, 16, 8, 1024)),
        vocoder=BigVGANConfig(
            num_mels=80, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),)),
        w2vbert=W2VBertConfig(
            hidden_size=1024, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=64, tap_layer=1, conv_depthwise_kernel_size=7),
        runtime=RuntimeConfig(diffusion_steps=2, max_mel_tokens=16))


def jax_cascade(cfg, params, inp):
    """_dryrun_sharded_cascade's unsharded reference: greedy decode, then
    its post_decode, with the JAX modules (attention on XLA)."""
    import jax
    import jax.numpy as jnp

    from indextts_tpu.models.bigvgan import BigVGAN
    from indextts_tpu.models.repcodec import RepCodec
    from indextts_tpu.models.s2mel import S2Mel
    from indextts_tpu.models.unified_voice import UnifiedVoice
    from indextts_tpu.runtime.decode import GPTDecoder, SamplingConfig
    from indextts_tpu.runtime.s2mel_infer import cfm_inference

    gpt, s2mel = UnifiedVoice(cfg.gpt, attn_impl="xla"), S2Mel(cfg.s2mel)
    repcodec, bigvgan = RepCodec(cfg.semantic_codec), BigVGAN(cfg.vocoder)
    dec = GPTDecoder(gpt, cfg.gpt, SamplingConfig(do_sample=False))
    text = inp["text"]
    B, Lt = text.shape
    ids, pos, valid = dec.build_text_prompt_arrays(text, np.full(B, Lt), Lt)
    conds = jnp.asarray(inp["conds"])
    res = dec.generate({"params": params["gpt"]}, conds, jnp.asarray(ids), jnp.asarray(pos),
                       jnp.asarray(valid), jax.random.PRNGKey(11), max_new=dryrun.CASCADE_NEW)
    ref_len = dryrun.REF_LEN
    target_len = int(np.floor(dryrun.CASCADE_NEW * 1.72))
    total_len = ref_len + target_len
    codes, code_len = res.codes, res.lengths
    latent = gpt.apply({"params": params["gpt"]}, conds, jnp.asarray(text),
                       jnp.full((B,), Lt), codes, code_len, jnp.asarray(inp["emovec"]),
                       method=UnifiedVoice.forward_latent)
    ps = {"params": params["s2mel"]}
    lat = s2mel.apply(ps, latent, method=S2Mel.project_gpt_latent)
    s_infer = repcodec.apply({"params": params["repcodec"]}, codes,
                             method=RepCodec.vq2emb) + lat
    target_lengths = jnp.floor(code_len.astype(jnp.float32) * 1.72).astype(jnp.int32)
    cond = s2mel.apply(ps, s_infer, target_lengths, target_len, code_len,
                       method=S2Mel.regulate)
    cat_cond = jnp.concatenate([jnp.asarray(inp["prompt_condition"]), cond], axis=1)
    x_lens = jnp.full((B,), ref_len) + target_lengths
    prompt_x = jnp.zeros((B, 80, total_len))
    prompt_x = jax.lax.dynamic_update_slice(prompt_x, jnp.asarray(inp["ref_mel"]), (0, 0, 0))
    vc = cfm_inference(s2mel, ps, cat_cond, x_lens, prompt_x, jnp.asarray(ref_len),
                       jnp.asarray(inp["style"]), jnp.asarray(inp["noise"]),
                       n_steps=2, cfg_rate=0.7)
    wav = bigvgan.apply({"params": params["bigvgan"]}, vc)
    return np.asarray(codes), np.asarray(wav)


@pytest.mark.parametrize("head_dim", [None, 64], ids=["jax_widths", "card_widths"])
def test_unsharded_cascade_matches_jax(head_dim):
    jcfg = jax_cascade_config(head_dim)
    cfg = dryrun.cascade_config(head_dim)
    assert to_port_config(jcfg) == cfg
    if head_dim is None:  # the dryrun's own configuration, as JAX builds it
        assert (cfg.gpt.model_dim, cfg.s2mel.dit.hidden_dim, cfg.s2mel.dit.depth) == (64, 32, 2)
    params = parity_params(jcfg, seed=0)
    models = dryrun.cascade_models(cfg, "cpu", from_jax_params(params, cfg))
    inp = dryrun.cascade_inputs(cfg, 2)
    got = dryrun.run_cascade(models, cfg, {k: torch.as_tensor(v) for k, v in inp.items()})
    codes, wav = jax_cascade(jcfg, params, inp)
    assert codes.shape == (2, dryrun.CASCADE_NEW) and not np.array_equal(codes[0], codes[1])
    np.testing.assert_array_equal(got["codes"].numpy(), codes)
    peak = np.abs(wav).max()
    assert 0 < peak < 1.0 and np.isfinite(wav).all()  # off the clip
    assert got["wav"].shape == wav.shape
    assert np.abs(got["wav"].numpy() - wav).max() <= 1e-3 * peak


def test_mesh_and_configs_follow_the_jax_dryrun():
    """The mesh rule (__graft_entry__.py:91-93) and the widths that the
    model axis sets."""
    assert [dryrun.mesh_shape(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (1, 2), (1, 3), (2, 2), (2, 3), (2, 4)]
    g = dryrun.train_config(2).gpt
    assert (g.model_dim, g.heads, g.number_text_tokens, g.stop_mel_token) == (128, 2, 96, 49)
    g = dryrun.decode_config(2).gpt
    assert (g.model_dim, g.heads, g.number_text_tokens, g.number_mel_codes) == (320, 20, 79, 16)
    assert dryrun.decode_config(2, 64).gpt.head_dim == 64
    assert dataclasses.replace(dryrun.cascade_config(64).s2mel.dit).head_dim == 64
    assert dryrun.default_head_dim("cpu") is None and dryrun.default_head_dim("cuda") == 64

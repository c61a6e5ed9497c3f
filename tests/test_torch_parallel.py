"""The port's parallel/ (torch.distributed) against the JAX package's
parallel/ tests (tests/test_parallel.py, tests/test_multihost_2proc.py), on
the CPU over gloo, at the tiny size.

In this process:
* the rule placement (c_attn column-cut by heads, c_proj row-cut, the
  vocabulary axes, the DiT's), the JAX tables' rows in the port's names;
* `maybe_initialize_distributed` a strict no-op for one process;
* the shards of every rule, put back together along the rule's axis (q, k
  and v by heads), rebuild the unsharded tensors exactly, for the float,
  W8 and W4 GPT and the DiT, over 2 and 4 ranks;
* `shard_params(strict=True)` raising on an axis that does not divide,
  naming it;
* a one-rank mesh, where tensor_parallel's wrapped layers run without a
  collective, gives the unsharded codes.

In 4 processes (mesh (2, 2); tests/torch_parallel_worker.py `tp`), each
held to the JAX package's unsharded result on the same parameters:
* the mesh layout (ranks, groups, global_mesh(model=2));
* forward_latent (1e-4 of the largest value) and the speaker conditioning
  (conformer FFNs cut; 1e-4) on each data rank's rows;
* the DiT velocity (DiT cut, K3's plain version over 2 of 4 heads; 1e-4);
* greedy decode, float and W8A8 (the plain contraction, int32 sums
  reduced before the scales), token-exact, with 2 of 4 heads in a rank's
  cache.

In 2 processes through `maybe_initialize_distributed()` with a localhost
TARS_COORDINATOR (worker `dp`, the shape of test_multihost_2proc.py): a
DP-split greedy decode token-exact with the one-process loop and with JAX;
two data-parallel steps of each target (finetune.data_parallel_step, 2 of
4 rows a rank, the CFM noise given for the 4 and sliced) held to JAX's
steps on the same global batches (tests/test_torch_train.py's tolerances):
the ranks' mean loss within 1e-5 relative, the averaged gradient that AdamW
is given at each step within 1e-4 of each leaf's largest |value| of JAX's
gradient over the global batch (so that a sum, or any other wrong scale,
fails: AdamW's update ignores the gradient's scale, the parameters alone
cannot show it), and the parameters after within 1e-2 of JAX's update
(an element whose gradient the gradient check cannot resolve, within 2 lr
a step: Adam's step normalizes away its size, so float32 rounding decides
its sign, as that test's docstring measures);
`finetune.main` one step of each target over the data axis, and a resume,
against the one-process runs on the same global batch: loss within 1e-5
relative, and parameters within 1e-5 + 1e-5 relative after two steps, 1% of
the learning rate (1e-3): AdamW moves each weight by about the learning
rate times m / sqrt(v), which amplifies the float32 difference of the
gradient averages where a weight's two gradients nearly cancel in m.
Every spawned process has its own timeout (WORKER_TIMEOUT).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu_torch import finetune
from indextts_tpu_torch.parallel import multihost
from indextts_tpu_torch.parallel.sharding import (
    DIT_PARTITION_RULES,
    GPT_PARTITION_RULES,
    Mesh,
    P,
    placement,
    shard_params,
)
from indextts_tpu_torch.weights import from_jax_params, quantize_gpt_state_dict
from torch_parity import n, parity_config, parity_params, t, to_port_config

WORKER = Path(__file__).parent / "torch_parallel_worker.py"
WORKER_TIMEOUT = 300
SEED = 2
B, LT, MAX_NEW = 4, 6, 12
TRAIN_LR, TRAIN_STEPS = 1e-3, 2


@pytest.fixture(scope="module")
def setup():
    cfg = parity_config()
    pcfg = to_port_config(cfg)
    jp = parity_params(cfg, seed=SEED)
    sds = from_jax_params(jp, pcfg)
    return cfg, pcfg, jp, sds


def _decode_inputs(jdec):
    rng = np.random.default_rng(42)
    text = rng.integers(2, 50, (B, LT))
    lens = np.array([LT, LT - 1, LT - 2, LT])
    ids, pos, valid = jdec.build_text_prompt_arrays(text, lens, LT)
    conds = rng.standard_normal((B, 34, 64)).astype(np.float32)
    return conds, ids, pos, valid


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(job: str, procs: int, setup_path: Path, out_dir: Path):
    """`procs` worker processes of `job`, each under its own timeout; their
    outputs, one a rank."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, TARS_COORDINATOR=coord, TARS_NUM_PROCESSES=str(procs),
               OMP_NUM_THREADS="1")
    ps = [subprocess.Popen([sys.executable, str(WORKER), job, str(setup_path), str(out_dir)],
                           env=dict(env, TARS_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
          for r in range(procs)]
    logs = []
    try:
        for p in ps:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(ps, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, f"{job} rank {r}:\n{log[-4000:]}"
    return [torch.load(out_dir / f"{job}_{r}.pt", weights_only=False) for r in range(procs)]


def _jax_decoder(cfg, quantize=False):
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
    from indextts_tpu.runtime.decode import SamplingConfig as JSampling

    return JDecoder(JUV(cfg.gpt, attn_impl="xla", quantize_gpt=quantize), cfg.gpt,
                    JSampling(do_sample=False))


def _jax_codes(cfg, tree, inputs, quantize=False):
    jdec = _jax_decoder(cfg, quantize)
    res = jdec.generate({"params": tree}, *(jnp.asarray(a) for a in inputs),
                        jax.random.PRNGKey(0), max_new=MAX_NEW)
    return np.asarray(res.codes), np.asarray(res.lengths)


@pytest.fixture(scope="module")
def shared(setup, tmp_path_factory):
    """setup.pt for the workers (the port's configs, state dicts and
    inputs) and the JAX package's unsharded results on the same values."""
    from indextts_tpu.models.s2mel import S2Mel as JS2Mel
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime.torch_convert import quantize_gpt_tree

    cfg, pcfg, jp, sds = setup
    d = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(7)
    D = cfg.gpt.model_dim
    fwd = dict(spk=rng.standard_normal((B, 32, D)).astype(np.float32),
               text=rng.integers(2, 50, (B, 8)), text_lens=np.array([8, 7, 5, 8]),
               codes=rng.integers(0, 34, (B, 10)), code_lens=np.array([10, 9, 10, 6]),
               emovec=rng.standard_normal((B, D)).astype(np.float32),
               feats=rng.standard_normal((B, 40, 1024)).astype(np.float32),
               feat_lens=np.array([40, 23, 31, 40]))
    T = 48
    vel = dict(x=rng.standard_normal((B, 80, T)).astype(np.float32),
               prompt_x=rng.standard_normal((B, 80, T)).astype(np.float32),
               x_lens=np.array([48, 31, 40, 48]), t=np.array([0.3, 0.75, 0.5, 0.1], np.float32),
               style=rng.standard_normal((B, 192)).astype(np.float32),
               cond=rng.standard_normal((B, T, 32)).astype(np.float32))
    jdec = _jax_decoder(cfg)
    dec_in = _decode_inputs(jdec)

    jgpt = JUV(cfg.gpt)
    want = {
        "forward_latent": np.asarray(jgpt.apply(
            {"params": jp["gpt"]}, *(jnp.asarray(fwd[k]) for k in
                                     ("spk", "text", "text_lens", "codes", "code_lens", "emovec")),
            method=JUV.forward_latent)),
        "conditioning": np.asarray(jgpt.apply(
            {"params": jp["gpt"]}, jnp.asarray(fwd["feats"]), jnp.asarray(fwd["feat_lens"]),
            method=JUV.get_conditioning)),
        "velocity": np.asarray(JS2Mel(cfg.s2mel).apply(
            {"params": jp["s2mel"]}, *(jnp.asarray(v) for v in vel.values()),
            method=JS2Mel.velocity)),
        "codes": _jax_codes(cfg, jp["gpt"], dec_in),
        "w8_codes": _jax_codes(cfg, quantize_gpt_tree(jp["gpt"]), dec_in, quantize=True),
    }
    ints = ("text", "text_lens", "codes", "code_lens", "feat_lens", "x_lens")
    as_t = lambda dd: {k: t(v, torch.long) if k in ints else t(v) for k, v in dd.items()}
    conds, ids, pos, valid = dec_in
    train_jp, train_sds, runs = _train_inputs(cfg, pcfg, jp)
    data_dirs = {}
    for target, run in runs.items():
        data_dirs[target] = str(d / f"ft_data_{target}")
        os.makedirs(data_dirs[target])
        np.savez(os.path.join(data_dirs[target], "b0.npz"), **run["batches"][0])
    torch.save({
        "train": {"lr": TRAIN_LR, "gpt_sd": train_sds["gpt"], "cfm_sd": train_sds["s2mel"],
                  "data_dirs": data_dirs,
                  "runs": {target: {"batches": [finetune.to_device(b, torch.device("cpu"))
                                                for b in run["batches"]],
                                    "noises": [None if z is None else tuple(t(x) for x in z)
                                               for z in run["noises"]]}
                           for target, run in runs.items()}},
        "cfg": pcfg, "gpt_cfg": pcfg.gpt, "s2mel_cfg": pcfg.s2mel,
        "gpt_sd": sds["gpt"], "gpt_w8_sd": quantize_gpt_state_dict(sds["gpt"], head=False),
        "s2mel_sd": sds["s2mel"], "forward": as_t(fwd), "velocity": as_t(vel),
        "decode": {"conds": t(conds), "ids": t(ids), "pos": t(pos), "valid": t(valid),
                   "max_new": MAX_NEW},
    }, d / "setup.pt")
    return d, dict(want, train=(train_jp, train_sds, runs))


def _train_inputs(cfg, pcfg, jp):
    """The parameters (a seeded text_head added to the GPT, as
    tests/test_torch_train.py does) in both layouts, and TRAIN_STEPS global
    batches of 4 rows for each target, with the CFM's noise (t, z and a CFG
    drop of row 1)."""
    rng = np.random.default_rng(21)
    g = cfg.gpt
    a = np.sqrt(3.0 / g.model_dim)
    train_jp = dict(jp, gpt=dict(jp["gpt"], text_head={
        "kernel": rng.uniform(-a, a, (g.model_dim, g.number_text_tokens + 1)).astype(np.float32),
        "bias": rng.uniform(-0.1, 0.1, g.number_text_tokens + 1).astype(np.float32)}))
    train_jp = jax.tree_util.tree_map(np.asarray, train_jp)
    sds = from_jax_params(train_jp, pcfg, text_head=True)
    runs = {"gpt": {"batches": [finetune.synthetic_gpt_batch(cfg, B, np.random.default_rng(30 + i))
                                for i in range(TRAIN_STEPS)]},
            "cfm": {"batches": [finetune.synthetic_cfm_batch(cfg, B, np.random.default_rng(40 + i))
                                for i in range(TRAIN_STEPS)]}}
    runs["gpt"]["noises"] = [None] * TRAIN_STEPS
    runs["cfm"]["noises"] = [
        (r.uniform(0, 1, B).astype(np.float32),
         r.standard_normal(b["x1"].shape).astype(np.float32), np.arange(B) == 1)
        for r, b in ((np.random.default_rng(50 + i), b)
                     for i, b in enumerate(runs["cfm"]["batches"]))]
    return train_jp, sds, runs


def _jax_train_steps(target, cfg, params, run):
    """JAX's AdamW steps (optax.adamw(TRAIN_LR)) over the global batches:
    each step's loss and gradient tree, and the parameters after."""
    import optax

    from indextts_tpu.models.s2mel import S2Mel as JS2Mel
    from indextts_tpu.models.unified_voice import UnifiedVoice as JUV
    from indextts_tpu.runtime import train as jax_train

    if target == "gpt":
        model = JUV(cfg.gpt)

        def loss_fn(p, b, noise):
            return jax_train.mel_text_loss(model, {"params": p}, *(b[k] for k in (
                "spk_latents", "text_ids", "text_lens", "mel_codes", "mel_lens", "emovec")))
    else:
        model = JS2Mel(cfg.s2mel)

        def loss_fn(p, b, noise):
            return jax_train.cfm_loss(model, {"params": p}, *(b[k] for k in (
                "x1", "x_lens", "prompt_lens", "mu", "style")), *noise)[0]

    opt = optax.adamw(TRAIN_LR)

    @jax.jit
    def step(p, o, b, noise):
        loss, grads = jax.value_and_grad(loss_fn)(p, b, noise)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, grads

    state = opt.init(params)
    losses, grads = [], []
    for b, noise in zip(run["batches"], run["noises"]):
        params, state, loss, g = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                      () if noise is None else tuple(map(jnp.asarray, noise)))
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_map(np.asarray, g))
    return losses, grads, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tp_run(shared):
    d, _ = shared
    return _launch("tp", 4, d / "setup.pt", d)


@pytest.fixture(scope="module")
def dp_run(shared):
    d, _ = shared
    return _launch("dp", 2, d / "setup.pt", d)


def _gathered(outs, key):
    """The data ranks' rows (model coordinate 0) in data order."""
    rows = sorted((o for o in outs if o["coord"]["model"] == 0), key=lambda o: o["coord"]["data"])
    return np.concatenate([n(o[key]) for o in rows])


def _model_ranks_agree(outs, key):
    for o in outs:
        (twin,) = [p for p in outs if p["coord"]["data"] == o["coord"]["data"] and p is not o]
        np.testing.assert_array_equal(n(o[key]), n(twin[key]))


# -- in this process ----------------------------------------------------------


def test_partition_rules_place_the_big_matrices(setup):
    """As JAX's: c_attn column-cut (by heads: parts=3), c_proj row-cut, the
    MLP likewise; the vocabulary axes; the W8 scales with their output
    axes; the DiT's wqkv by heads and wo row-cut, in nn.Linear's (out, in)
    orientation; norms replicated."""
    _, pcfg, _, sds = setup
    mesh = Mesh(1, 4)
    gpt = sds["gpt"]

    def spec(name, sd=gpt, rules=GPT_PARTITION_RULES):
        return placement(name, sd[name].shape, mesh, rules)[0]

    assert spec("gpt.h.0.attn.c_attn.weight") == P(None, "model", parts=3)
    assert spec("gpt.h.0.attn.c_attn.bias") == P("model", parts=3)
    assert spec("gpt.h.0.attn.c_proj.weight") == P("model", None)
    assert spec("gpt.h.0.attn.c_proj.bias") == P()
    assert spec("gpt.h.1.mlp.c_fc.weight") == P(None, "model")
    assert spec("gpt.h.1.mlp.c_proj.weight") == P("model", None)
    assert spec("mel_embedding.weight") == P("model", None)
    assert spec("mel_head.weight") == P("model", None)
    assert spec("mel_head.bias") == P("model")
    assert spec("gpt.h.0.ln_1.weight") == P()
    assert spec("conditioning_encoder.encoders.0.feed_forward.w_1.weight") == P("model", None)
    assert spec("emo_conditioning_encoder.encoders.0.feed_forward.w_2.weight") == P(None, "model")
    # 51 text ids do not divide: replicated, as JAX's 65-row tiny embedding
    assert spec("text_embedding.weight") == P(None, None)
    w8 = quantize_gpt_state_dict(gpt, head=True)
    assert spec("gpt.h.0.attn.c_attn.weight_q", w8) == P(None, "model", parts=3)
    assert spec("gpt.h.0.attn.c_attn.weight_scale", w8) == P("model", parts=3)
    assert spec("gpt.h.0.attn.c_proj.weight_scale", w8) == P()
    assert spec("mel_head.weight_q", w8) == P(None, "model")
    w4 = quantize_gpt_state_dict(gpt, head=True, bits=4)
    assert spec("gpt.h.0.attn.c_proj.weight_q4", w4) == P()
    assert spec("gpt.h.0.mlp.c_proj.weight_q4", w4) == P("model", None)
    s2 = sds["s2mel"]
    pre = "cfm.estimator.transformer.layers.2."
    for name, want in (("attention.wqkv.weight", P("model", None, parts=3)),
                       ("attention.wo.weight", P(None, "model")),
                       ("feed_forward.w1.weight", P("model", None)),
                       ("feed_forward.w2.weight", P(None, "model"))):
        assert spec(pre + name, s2, DIT_PARTITION_RULES) == want


def test_multihost_noop_single_process(monkeypatch):
    """A strict no-op without topology envs and with an explicit
    single-process topology; a partial topology raises."""
    for k in ("TARS_COORDINATOR", "JAX_COORDINATOR_ADDRESS", "TARS_NUM_PROCESSES",
              "JAX_NUM_PROCESSES", "TARS_PROCESS_ID", "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("TARS_NUM_PROCESSES", "1")
    assert multihost.maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("TARS_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="TARS_COORDINATOR"):
        multihost.maybe_initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh(model=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    with pytest.raises(ValueError):
        multihost.global_mesh(model=2)


def _rebuild(shards, spec: P):
    """The unsharded tensor from its shards in rank order: along each cut
    axis, the ranks' pieces of each of the spec's parts in order."""
    (dim,) = [i for i, a in enumerate(spec.axes) if a is not None]
    blocks = [s.chunk(spec.parts, dim=dim) for s in shards]
    return torch.cat([b[p] for p in range(spec.parts) for b in blocks], dim=dim)


@pytest.mark.parametrize("model", [2, 4])
def test_shards_rebuild_every_tensor(setup, model):
    """shard_params on the state dicts weights.py makes from the JAX
    parameters: every cut tensor's shards, put back together by the rule's
    axis (q, k and v each by heads), are the unsharded tensor bit for bit;
    every other tensor is the unsharded one. W8 and W4 layouts included."""
    _, _, _, sds = setup
    cases = [(sds["gpt"], GPT_PARTITION_RULES),
             (quantize_gpt_state_dict(sds["gpt"], head=True), GPT_PARTITION_RULES),
             (quantize_gpt_state_dict(sds["gpt"], head=True, bits=4), GPT_PARTITION_RULES),
             (sds["s2mel"], DIT_PARTITION_RULES)]
    cut = 0
    for sd, rules in cases:
        shards = [shard_params(sd, Mesh(1, model, rank=r), rules) for r in range(model)]
        for name, full in sd.items():
            spec = placement(name, full.shape, Mesh(1, model), rules)[0]
            if any(a is not None for a in spec.axes):
                cut += 1
                assert shards[0][name].numel() * model == full.numel(), name
                assert torch.equal(_rebuild([s[name] for s in shards], spec), full), name
            else:
                assert all(s[name] is full for s in shards), name
    assert cut > 40


def test_strict_raises_on_an_axis_that_does_not_divide(setup):
    """At model=4 the tiny text embedding's 51 rows and the 36-code mel
    vocabulary (36 % 4 == 0) differ: strict names the first, non-strict
    replicates it."""
    _, _, _, sds = setup
    with pytest.raises(ValueError, match=r"text_embedding\.weight: shape \(51, 64\) axis 0"):
        shard_params(sds["gpt"], Mesh(1, 4), GPT_PARTITION_RULES, strict=True)
    out = shard_params(sds["gpt"], Mesh(1, 4, rank=3), GPT_PARTITION_RULES)
    assert out["text_embedding.weight"] is sds["gpt"]["text_embedding.weight"]
    assert out["mel_embedding.weight"].shape == (9, 64)


def test_one_rank_mesh_runs_the_wrapped_layers(setup, shared):
    """tensor_parallel at (1, 1) in one process wraps every cut layer
    (RowParallel, VocabParallelEmbedding, GatherColumns) with no group to
    reduce over: its greedy codes are the unsharded model's and JAX's."""
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.parallel.tp import GatherColumns, RowParallel, tensor_parallel
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    cfg, pcfg, _, sds = setup
    model = UnifiedVoice(pcfg.gpt)
    model.load_state_dict(sds["gpt"])
    tensor_parallel(model.eval().requires_grad_(False), Mesh(1, 1), GPT_PARTITION_RULES)
    assert isinstance(model.gpt.h[0].attn.c_proj, RowParallel)
    assert isinstance(model.mel_head, GatherColumns)
    dec = GPTDecoder(model, pcfg.gpt, SamplingConfig(do_sample=False))
    inputs = _decode_inputs(_jax_decoder(cfg))
    got = dec.generate(*(t(a) for a in inputs), None, max_new=MAX_NEW, eager=True)
    codes, lengths = shared[1]["codes"]
    np.testing.assert_array_equal(n(got.codes), codes)
    np.testing.assert_array_equal(n(got.lengths), lengths)


@pytest.mark.parametrize("route", ["w4", "gemv"])
def test_tensor_parallel_refuses_w4_and_the_gemv_kernels(setup, route):
    """W4 blocks (whose attn c_proj the rules replicate) and layers on the
    GEMV kernels are not cut: tensor_parallel raises instead of running
    them at the wrong widths."""
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.parallel.tp import tensor_parallel

    _, pcfg, _, sds = setup
    bits = 4 if route == "w4" else 8
    model = UnifiedVoice(pcfg.gpt, quantize=True, wbits=bits, gemv=route == "gemv")
    model.load_state_dict(quantize_gpt_state_dict(sds["gpt"], head=False, bits=bits))
    with pytest.raises(NotImplementedError, match="plain contraction"):
        tensor_parallel(model, Mesh(1, 1), GPT_PARTITION_RULES)


# -- 4 processes, mesh (2, 2) -------------------------------------------------


def test_mesh_layout(tp_run):
    """rank = data * 2 + model; each rank's model group is its data row, its
    data group its model column; global_mesh(model=2) over 4 processes is
    (data=2, model=2)."""
    for o in tp_run:
        r = o["rank"]
        assert o["coord"] == {"data": r // 2, "model": r % 2}
        assert o["model_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert o["data_ranks"] == [r % 2, r % 2 + 2]
        assert o["global_mesh"] == {"data": 2, "model": 2}


def _assert_rel(got, want, tol, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < tol, f"{what}: max error {err:.2e} of the largest value"


def test_tp_forward_matches_unsharded(tp_run, shared):
    """forward_latent (c_attn/c_fc cut, c_proj all-reduced, the mel
    embedding cut on its vocabulary) and the speaker conditioning (the
    conformers' FFNs cut) on each data rank's rows, within 1e-4 of the
    largest value of JAX's unsharded results; both ranks of a model group
    agree."""
    want = shared[1]
    for key in ("forward_latent", "conditioning"):
        _model_ranks_agree(tp_run, key)
        _assert_rel(_gathered(tp_run, key), want[key], 1e-4, key)


def test_dit_tp_velocity_matches_unsharded(tp_run, shared):
    """The DiT cut by DIT_PARTITION_RULES (2 of 4 heads a rank), within
    1e-4 of the largest value of JAX's unsharded velocity."""
    assert all(o["dit_heads"] == 2 for o in tp_run)
    _model_ranks_agree(tp_run, "velocity")
    _assert_rel(_gathered(tp_run, "velocity"), shared[1]["velocity"], 1e-4, "velocity")


def test_tp_decode_token_exact(tp_run, shared):
    """Greedy float decode, each data rank's 2 rows, 2 of 4 heads in a
    rank's cache: JAX's unsharded codes and lengths."""
    codes, lengths = shared[1]["codes"]
    for o in tp_run:
        assert o["cache_shape"][2] == 2
    _model_ranks_agree(tp_run, "codes")
    np.testing.assert_array_equal(_gathered(tp_run, "codes"), codes)
    np.testing.assert_array_equal(_gathered(tp_run, "lengths"), lengths)
    assert len(set(codes.ravel().tolist())) > 6


def test_tp_decode_w8_token_exact(tp_run, shared):
    """W8A8 blocks on the plain contraction: the row-cut layers' amax and
    int32 partial sums reduced before the scales, so that the codes are
    JAX's unsharded quantized loop's."""
    codes, lengths = shared[1]["w8_codes"]
    _model_ranks_agree(tp_run, "w8_codes")
    np.testing.assert_array_equal(_gathered(tp_run, "w8_codes"), codes)
    np.testing.assert_array_equal(_gathered(tp_run, "w8_lengths"), lengths)


# -- 2 processes through the TARS_* env, data axis -----------------------------


def test_two_process_dp_decode(dp_run, shared):
    """Each process decodes its 2 rows; gathered over the data axis they are
    the one-process loop's codes (asserted in the workers) and JAX's."""
    codes, _ = shared[1]["codes"]
    for o in dp_run:
        np.testing.assert_array_equal(n(o["dp_codes"]), codes)


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_data_parallel_steps_match_jax(dp_run, shared, setup, target):
    """Two data-parallel steps (2 of 4 rows a rank, gradients averaged over
    the data axis) against JAX's steps over the 4 rows: the ranks' mean
    loss; at each step the gradient each rank hands AdamW, leaf by leaf
    against JAX's gradient over the global batch (a summed or wrongly scaled
    average fails here); the parameters after, against JAX's; both ranks
    hold the same gradients and parameters."""
    _hold_steps_to_jax([o[f"steps_{target}"] for o in dp_run], shared, setup, target)


def _hold_steps_to_jax(gots, shared, setup, target):
    """Each rank's record of the TRAIN_STEPS steps (`gots`: losses, the
    gradient AdamW was given at each step and the parameters after, in the
    full layout) against JAX's steps over the global batches: the loss
    within 1e-5 relative; each gradient leaf within 1e-4 of the largest
    |value| of JAX's; the parameters as the module's docstring says; every
    rank's gradients and parameters equal to the first's."""
    from indextts_tpu_torch import weights

    jcfg, pcfg = setup[0], setup[1]
    train_jp, train_sds, runs = shared[1]["train"]
    name = "gpt" if target == "gpt" else "s2mel"
    jlosses, jgrads, jparams = _jax_train_steps(target, jcfg, train_jp[name], runs[target])
    convert = ((lambda tree: weights.unified_voice_sd(tree, pcfg, text_head=True))
               if target == "gpt" else (lambda tree: weights.s2mel_sd(tree, pcfg)))
    got0 = gots[0]
    np.testing.assert_allclose(got0["losses"], jlosses, rtol=1e-5)
    assert len(got0["grads"]) == TRAIN_STEPS
    for i, jg in enumerate(jgrads):
        want = convert(jg)
        assert set(got0["grads"][i]) == set(want)
        for k, w in want.items():
            g0 = got0["grads"][i][k]
            for r, other in enumerate(gots[1:], 1):
                assert torch.equal(g0, other["grads"][i][k]), (
                    f"step {i + 1} {k}: rank {r} differs from rank 0")
            w = n(w)
            top = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(n(g0) - w).max())
            assert err <= 1e-4 * top, f"step {i + 1} {k}: gradient off by {err} of {top}"
    # the parameters: an element whose JAX gradient is, at some step, no
    # larger than the gradient check resolves (1e-4 of its leaf's largest)
    # has an Adam update of undetermined sign, m / sqrt(v) within +-1 a
    # step: it is held to 2 lr a step; the other elements as
    # test_three_adamw_steps_match_jax holds a whole tensor
    want, start = convert(jparams), train_sds[name]
    noise = [{k: torch.from_numpy(np.abs(n(g)) <= 1e-4 * np.abs(n(g)).max())
              for k, g in convert(jg).items()} for jg in jgrads]
    for k, w in want.items():
        p, w0 = got0["params"][k], start[k]
        for other in gots[1:]:
            assert torch.equal(p, other["params"][k]), f"{k}: the ranks' parameters differ"
        loose = torch.stack([m[k] for m in noise]).any(dim=0)
        off = (p - w)[loose].abs()
        assert off.numel() == 0 or float(off.max()) <= 2 * TRAIN_STEPS * TRAIN_LR * 1.001, k
        p, w, w0 = p[~loose], w[~loose], w0[~loose]
        err = float((p - w).norm())
        assert err <= 1e-2 * float((w - w0).norm()) + 1e-6 * w.numel() ** 0.5, (
            f"{k}: {err} against an update of {float((w - w0).norm())}")


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_data_parallel_finetune_matches_one_process(dp_run, shared, setup, target,
                                                    monkeypatch, tmp_path):
    """finetune.main over 2 processes (2 of 4 rows each, the CFM noise drawn
    for the 4 and sliced, gradients averaged): the JSON line's mesh is
    {data: 2, model: 1} and its loss the one-process run's within 1e-5;
    after a resume on both ranks from rank 0's checkpoint, the parameters
    are the one-process run's within 1e-5 + 1e-5 relative (the module's
    docstring says why)."""
    monkeypatch.setattr(finetune, "load_config", lambda *a, **k: setup[1])
    common = ["--device", "cpu", "--target", target, "--synthetic", "4", "--out-dir",
              str(tmp_path), "--log-every", "1", "--lr", "1e-3"]
    one = finetune.main(common + ["--steps", "1"])
    one_resumed = finetune.main(common + ["--steps", "1"])
    for o in dp_run:
        got, resumed = o[f"ft_{target}"], o[f"ft_{target}_resumed"]
        assert got["mesh"] == {"data": 2, "model": 1} and one["mesh"] == {"data": 1, "model": 1}
        assert (resumed["from_step"], resumed["final_step"]) == (1, 2)
        np.testing.assert_allclose(got["loss_first"], one["loss_first"], rtol=1e-5)
        np.testing.assert_allclose(resumed["loss_last"], one_resumed["loss_last"], rtol=1e-5)
    d = shared[0] / f"ft_{target}" / "latest"
    assert json.loads((d / "meta.json").read_text())["step"] == 2
    want = torch.load(tmp_path / "latest" / "params.pt")
    got = torch.load(d / "params.pt")
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)


# -- the model axis: training through the cut models --------------------------


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_one_rank_mesh_trains_as_unsharded(setup, shared, target):
    """tensor_parallel at (1, 1) in one process on a training model (f and
    g with no group): one loss and backward on the first global batch give
    the unwrapped model's loss and, under the unwrapped names (in the
    unwrapped model's parameter order, which the checkpoints' optimizer
    state relies on), its gradients, within 1e-5 of each leaf's largest."""
    from indextts_tpu_torch.parallel.sharding import (
        DIT_PARTITION_RULES as DR,
        GPT_PARTITION_RULES as GR,
    )
    from indextts_tpu_torch.parallel.tp import full_name, full_state, tensor_parallel
    from indextts_tpu_torch.runtime import train as T

    pcfg = setup[1]
    _, train_sds, runs = shared[1]["train"]
    sd = train_sds["gpt" if target == "gpt" else "s2mel"]
    batch = finetune.to_device(runs[target]["batches"][0], torch.device("cpu"))
    noise = runs[target]["noises"][0]

    def grads(model):
        if target == "gpt":
            loss = T.mel_text_loss(model, *(batch[k] for k in (
                "spk_latents", "text_ids", "text_lens", "mel_codes", "mel_lens", "emovec")))
        else:
            loss = T.cfm_loss(model, *(batch[k] for k in (
                "x1", "x_lens", "prompt_lens", "mu", "style")), *(t(x) for x in noise))[0]
        loss.backward()
        return float(loss), {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}

    plain = T.train_model(pcfg, target, "cpu", sd)
    cut = tensor_parallel(T.train_model(pcfg, target, "cpu", sd), Mesh(1, 1),
                          GR if target == "gpt" else DR)
    assert len(cut.tp_layout) > 4
    assert [full_name(cut, k) for k, _ in cut.named_parameters()] == [
        k for k, _ in plain.named_parameters()]
    loss, want = grads(plain)
    got_loss, got = grads(cut)
    got = full_state(cut, got)
    assert abs(got_loss - loss) <= 1e-6 * abs(loss)
    assert set(got) == set(want)
    for k, w in want.items():
        top = max(float(w.abs().max()), 1e-30)
        assert float((got[k] - w).abs().max()) <= 1e-5 * top, k


def _mp_outs(mesh, dp_run, tp_run):
    return dp_run if mesh == "1x2" else tp_run


@pytest.mark.parametrize("target", ["gpt", "cfm"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_model_parallel_steps_match_jax(dp_run, tp_run, shared, setup, mesh, target):
    """Two AdamW steps with the model cut over the model axis of a (1, 2)
    mesh (2 processes, every rank the 4 rows) and of a (2, 2) mesh (4
    processes, 2 rows a data rank), gradients through f and g, averaged over
    the data axis: the losses, the gradient AdamW is given gathered to the
    full layout (a missing f leaves a replicated leaf's gradient partial:
    the parameters alone cannot show it, AdamW normalizing the scale away)
    and the parameters after, held to JAX's steps over the 4 rows as the
    data axis's steps are; 2 of 4 heads a rank; the replicated parameters
    bit-equal on the ranks of a model group."""
    outs = _mp_outs(mesh, dp_run, tp_run)
    gots = [o[f"mp_{target}"] for o in outs]
    data = 1 if mesh == "1x2" else 2
    for g in gots:
        assert g["mesh"] == {"data": data, "model": 2} and g["heads"] == 2
    _hold_steps_to_jax(gots, shared, setup, target)
    group = (lambda o: o["coord"]["data"]) if mesh == "2x2" else (lambda o: 0)
    for o in outs:
        (twin,) = [p for p in outs if p is not o and group(p) == group(o)]
        mine, other = o[f"mp_{target}"]["local"], twin[f"mp_{target}"]["local"]
        assert set(mine) == set(other) and len(mine) > 10
        for k, v in mine.items():
            assert torch.equal(v, other[k]), f"{k}: the model ranks' replicated copies differ"


@pytest.mark.parametrize("target", ["gpt", "cfm"])
def test_model_parallel_checkpoint_resumes_at_one(dp_run, shared, setup, target, monkeypatch,
                                                 tmp_path):
    """finetune.main --model-parallel 2 over 2 processes, one step on a
    stored global batch of 4 rows, writes its checkpoint in the unwrapped
    layout (the one-process model's names and shapes, AdamW's moments
    gathered); --model-parallel 1 resumes it here for one more step. The
    GPT's two steps match an uninterrupted one-process run of two steps on
    the same batch; the CFM's, the one-process run that saves after its
    first step and resumes (a resumed run draws its noise from the seed
    plus its first step, so no uninterrupted run draws the same): the loss
    within 1e-5 relative, the parameters within 1e-5 + 1e-5 relative. The
    port's loader reads the GPT checkpoint as gpt.pth: load_engine's GPT
    state is the checkpoint's, its text_head dropped."""
    import shutil

    from indextts_tpu_torch.runtime.loader import convert_reference_checkpoints, load_engine

    pcfg = setup[1]
    monkeypatch.setattr(finetune, "load_config", lambda *a, **k: pcfg)
    data = str(shared[0] / f"ft_data_{target}")
    common = ["--device", "cpu", "--target", target, "--data-dir", data, "--batch", "4",
              "--log-every", "1", "--lr", "1e-3"]
    for o in dp_run:
        assert o[f"ft_mp_{target}"]["mesh"] == {"data": 1, "model": 2}
    written = shared[0] / f"ft_mp_{target}"
    params = torch.load(written / "latest" / "params.pt")
    want_shapes = {k: v.shape for k, v in finetune.T.train_model(
        pcfg, target, "cpu").state_dict().items()}
    assert {k: v.shape for k, v in params.items()} == want_shapes
    resumed_dir = tmp_path / "resumed"
    shutil.copytree(written, resumed_dir)
    resumed = finetune.main(common + ["--out-dir", str(resumed_dir), "--steps", "1"])
    assert (resumed["from_step"], resumed["final_step"], resumed["mesh"]) == (
        1, 2, {"data": 1, "model": 1})
    one_dir = tmp_path / "one"
    if target == "gpt":
        one = finetune.main(common + ["--out-dir", str(one_dir), "--steps", "2"])
    else:
        finetune.main(common + ["--out-dir", str(one_dir), "--steps", "1"])
        one = finetune.main(common + ["--out-dir", str(one_dir), "--steps", "1"])
    np.testing.assert_allclose(resumed["loss_last"], one["loss_last"], rtol=1e-5)
    want = torch.load(one_dir / "latest" / "params.pt")
    got = torch.load(resumed_dir / "latest" / "params.pt")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    if target == "gpt":
        d = tmp_path / "ckpt"
        d.mkdir()
        shutil.copy(written / "latest" / "params.pt", d / "gpt.pth")
        read, _ = convert_reference_checkpoints(str(d), pcfg, text_head=True)
        assert set(read["gpt"]) == set(params)
        for k, v in params.items():
            assert torch.equal(read["gpt"][k], v), k
        engine = load_engine(str(d), cfg=pcfg, device="cpu")
        assert "gpt" not in engine.load_report.filled
        for k, v in engine.gpt.state_dict().items():
            assert torch.equal(v, params[k]), k

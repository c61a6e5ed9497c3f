"""Worker for tests/test_torch_parallel.py: one of several OS processes of a
gloo job on the CPU, which imports the port and torch only.

Run as:  python torch_parallel_worker.py <job> <setup.pt> <out dir>
with TARS_COORDINATOR, TARS_NUM_PROCESSES and TARS_PROCESS_ID set, so that
`maybe_initialize_distributed(device="cpu")` joins the job over gloo.

Jobs:
  tp  (4 processes, mesh (2, 2)): the mesh layout; UnifiedVoice cut by
      GPT_PARTITION_RULES: forward_latent and the speaker conditioning
      (conformer FFNs cut) on this data rank's rows, and greedy decode on
      the float and the W8 GPT; S2Mel cut by DIT_PARTITION_RULES: the DiT
      velocity on this data rank's rows; two training steps of each target
      on the (2, 2) mesh (`model_parallel_steps`).
  dp  (2 processes, mesh (2, 1) from global_mesh): a DP-split greedy decode
      gathered over the data axis and held token-exact to this process's
      one-process loop; two steps of each target through
      finetune.data_parallel_step on the setup's global batches, recording
      the averaged gradients that AdamW is given (a step pre-hook), the
      losses averaged over the ranks and the parameters after; finetune.main
      one step of each target over the data axis, and a resume; two
      training steps of each target on a (1, 2) mesh
      (`model_parallel_steps`); finetune.main --model-parallel 2, one step
      of each target on one stored batch, with a checkpoint.

Each process writes out/<job>_<rank>.pt; the test compares them with the
JAX package's unsharded results.
"""

import os
import sys

import torch


def main() -> None:
    job, setup_path, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.set_num_threads(1)
    from indextts_tpu_torch.parallel import multihost

    assert multihost.maybe_initialize_distributed(device="cpu") is True
    assert torch.distributed.get_backend() == "gloo"
    setup = torch.load(setup_path, weights_only=False)
    out = (tp_job if job == "tp" else dp_job)(setup, out_dir)
    torch.save(out, os.path.join(out_dir, f"{job}_{torch.distributed.get_rank()}.pt"))
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {job} rank={out['rank']}", flush=True)


def _gpt(cfg, sd, quantize=False):
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice

    model = UnifiedVoice(cfg, quantize=quantize)
    model.load_state_dict(sd, strict=True)
    return model.eval().requires_grad_(False)


def _decode(model, cfg, inp, eager=True):
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    dec = GPTDecoder(model, cfg, SamplingConfig(do_sample=False))
    res = dec.generate(inp["conds"], inp["ids"], inp["pos"], inp["valid"], None,
                       max_new=inp["max_new"], do_sample=False, eager=eager)
    (st,) = dec._states.values()
    return res, st.caches[0].shape


def tp_job(setup, out_dir):
    from indextts_tpu_torch.models.s2mel import S2Mel
    from indextts_tpu_torch.parallel.data import local_rows
    from indextts_tpu_torch.parallel.multihost import global_mesh
    from indextts_tpu_torch.parallel.sharding import (
        DIT_PARTITION_RULES,
        GPT_PARTITION_RULES,
        make_mesh,
    )
    from indextts_tpu_torch.parallel.tp import tensor_parallel

    mesh = make_mesh(2, 2)
    out = {"rank": mesh.rank, "coord": mesh.coord, "model_ranks": mesh.ranks("model"),
           "data_ranks": mesh.ranks("data"), "global_mesh": global_mesh(model=2).shape}
    cfg = setup["gpt_cfg"]
    model = tensor_parallel(_gpt(cfg, setup["gpt_sd"]), mesh, GPT_PARTITION_RULES)
    fwd = local_rows(setup["forward"], mesh)
    with torch.inference_mode():
        out["forward_latent"] = model.forward_latent(
            fwd["spk"], fwd["text"], fwd["text_lens"], fwd["codes"], fwd["code_lens"],
            fwd["emovec"])
        out["conditioning"] = model.get_conditioning(fwd["feats"], fwd["feat_lens"])
    dec_rows = local_rows({k: v for k, v in setup["decode"].items() if k != "max_new"}, mesh)
    dec_in = dict(dec_rows, max_new=setup["decode"]["max_new"])
    res, shape = _decode(model, cfg, dec_in)
    out["codes"], out["lengths"], out["cache_shape"] = res.codes, res.lengths, shape
    w8 = tensor_parallel(_gpt(cfg, setup["gpt_w8_sd"], quantize=True), mesh,
                         GPT_PARTITION_RULES)
    res, _ = _decode(w8, cfg, dec_in)
    out["w8_codes"], out["w8_lengths"] = res.codes, res.lengths

    s2mel = S2Mel(setup["s2mel_cfg"])
    s2mel.load_state_dict(setup["s2mel_sd"], strict=True)
    tensor_parallel(s2mel.eval().requires_grad_(False), mesh, DIT_PARTITION_RULES)
    v = local_rows(setup["velocity"], mesh)
    with torch.inference_mode():
        out["velocity"] = s2mel.velocity(v["x"], v["prompt_x"], v["x_lens"], v["t"],
                                         v["style"], v["cond"])
    out["dit_heads"] = s2mel.cfm.estimator.transformer.layers[0].attention.h
    out.update(model_parallel_steps(setup, mesh))
    return out


def model_parallel_steps(setup, mesh):
    """The setup's training steps of each target with the model cut over
    `mesh`'s model axis (runtime/train.py train_model(mesh=)) through
    finetune.data_parallel_step: the losses averaged over the data axis;
    at each step the gradient AdamW is given, gathered to the full layout
    (parallel/tp.py full_state, in a step pre-hook); the parameters after,
    gathered, and this rank's replicated ones as they are."""
    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.parallel.sharding import all_reduce
    from indextts_tpu_torch.parallel.tp import full_state
    from indextts_tpu_torch.runtime import train as T

    out = {}
    for target, run in setup["train"]["runs"].items():
        model = T.train_model(setup["cfg"], target, "cpu", setup["train"][f"{target}_sd"],
                              mesh=mesh)
        opt = T.adamw(model.parameters(), setup["train"]["lr"])
        grads = []
        opt.register_step_pre_hook(lambda *_: grads.append(full_state(
            model, {k: p.grad.clone() for k, p in model.named_parameters()})))
        step = finetune.data_parallel_step(target, model, opt, mesh)
        losses = []
        for batch, noise in zip(run["batches"], run["noises"]):
            loss = step(batch, noise=noise)
            losses.append(float(all_reduce(loss.clone(), mesh, axis="data"))
                          / mesh.shape["data"])
        local = {k: v.clone() for k, v in model.state_dict().items()
                 if model.tp_names[k] not in model.tp_layout}
        heads = (model.gpt.h[0].attn.n_head if target == "gpt"
                 else model.cfm.estimator.transformer.layers[0].attention.h)
        out[f"mp_{target}"] = {"losses": losses, "grads": grads, "local": local,
                               "params": full_state(model, model.state_dict()),
                               "mesh": dict(mesh.shape), "heads": heads}
    return out


def dp_job(setup, out_dir):
    import torch.distributed as dist

    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.parallel.data import local_rows
    from indextts_tpu_torch.parallel.multihost import global_mesh
    from indextts_tpu_torch.parallel.sharding import make_mesh

    mesh = global_mesh(model=1)
    assert mesh.shape == {"data": 2, "model": 1}
    rank = mesh.rank
    out = {"rank": rank}
    cfg = setup["gpt_cfg"]
    model = _gpt(cfg, setup["gpt_sd"])
    inp = setup["decode"]
    whole, _ = _decode(model, cfg, inp)
    rows = dict(local_rows({k: v for k, v in inp.items() if k != "max_new"}, mesh),
                max_new=inp["max_new"])
    mine, _ = _decode(model, cfg, rows)
    gathered = [torch.empty_like(mine.codes) for _ in range(2)]
    dist.all_gather(gathered, mine.codes, group=mesh.group("data"))
    codes = torch.cat(gathered)
    assert torch.equal(codes, whole.codes), (codes, whole.codes)
    out["dp_codes"] = codes

    from indextts_tpu_torch.parallel.sharding import all_reduce
    from indextts_tpu_torch.runtime import train as T

    for target, run in setup["train"]["runs"].items():
        model = T.train_model(setup["cfg"], target, "cpu", setup["train"][f"{target}_sd"])
        opt = T.adamw(model.parameters(), setup["train"]["lr"])
        grads = []
        opt.register_step_pre_hook(lambda *_: grads.append(
            {k: p.grad.clone() for k, p in model.named_parameters()}))
        step = finetune.data_parallel_step(target, model, opt, mesh)
        losses = []
        for batch, noise in zip(run["batches"], run["noises"]):
            loss = step(batch, noise=noise)
            losses.append(float(all_reduce(loss.clone(), mesh, axis="data")) / 2)
        out[f"steps_{target}"] = {"losses": losses, "grads": grads,
                                  "params": {k: v.clone() for k, v in model.state_dict().items()}}

    finetune.load_config = lambda *a, **k: setup["cfg"]
    for target in ("gpt", "cfm"):
        d = os.path.join(out_dir, f"ft_{target}")
        common = ["--device", "cpu", "--target", target, "--synthetic", "4", "--out-dir", d,
                  "--log-every", "1", "--lr", "1e-3"]
        out[f"ft_{target}"] = finetune.main(common + ["--steps", "1"])
        out[f"ft_{target}_resumed"] = finetune.main(common + ["--steps", "1"])

    out.update(model_parallel_steps(setup, make_mesh(1, 2)))
    for target in ("gpt", "cfm"):
        out[f"ft_mp_{target}"] = finetune.main(
            ["--device", "cpu", "--target", target, "--data-dir",
             setup["train"]["data_dirs"][target], "--batch", "4", "--out-dir",
             os.path.join(out_dir, f"ft_mp_{target}"), "--log-every", "1", "--lr", "1e-3",
             "--model-parallel", "2", "--steps", "1"])
    return out


if __name__ == "__main__":
    main()

"""The (data, model) dryrun: the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip(n)`, over torch.distributed.

  python -m indextts_tpu_torch.parallel.dryrun --procs 4 --device cpu
  python -m indextts_tpu_torch.parallel.dryrun --procs 4        # the card(s)

`dryrun_multichip(n)` starts n worker processes and builds the mesh as the
JAX dryrun does: (2, n / 2) where n >= 4 is even, else (1, n)
(sharding.py `make_mesh(data, model)`). Each worker runs the JAX dryrun's
three parts at its configurations and sizes, and holds each to the same
work done unsharded in that process:

  (a) one GPT training step, the model cut by GPT_PARTITION_RULES over the
      model axis and the batch (B = max(2 data, 2)) over the data axis
      (finetune.py `data_parallel_step`): a finite loss, the data ranks'
      mean within 1e-5 relative of the one-process step's;
  (b) a greedy decode of the 20-head GPT cut over the model axis, its rows
      over the data axis (B = max(2 data, 2), Lt 6, max_new 4): the
      gathered codes equal the unsharded decode's;
  (c) the inference cascade at `_dryrun_sharded_cascade`'s configuration
      (GPT 64 wide, 2 layers; DiT 32 wide, 2 layers; 2 CFM steps; a small
      BigVGAN): decode, latent pass, length regulator, CFM, vocoder, with
      the rows over the data axis (data.py `local_rows`), gathered at the
      end, and the GPT and DiT cut over the model axis (tp.py
      `tensor_parallel`): codes equal to the unsharded ones, the waveform
      within 2e-4 x the unsharded peak.

The backend is chosen here and printed: gloo on the CPU; NCCL with one
process a card where there are n cards; gloo where ranks share a card,
which NCCL refuses. Decodes run eagerly: a collective cannot be captured
in a CUDA graph under gloo.

Head widths: the JAX configurations' attentions are 16 (GPT) and 8 (DiT)
wide. The port's attention kernels K1 and K3 take a head dim of 64 only,
so on the card every attention's heads are 64 wide (the head counts, the
layer counts and every other width as JAX's). Each rank reports its
launches of K1, K3 and K2 in (b) and (c) and the shapes it gave K1 and K3
(chip_smoke.py holds the kernels to their plain versions at those
shapes).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from indextts_tpu_torch.config import (
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

WORKER_TIMEOUT = 300  # seconds a worker process may take
RESULT = "DRYRUN_RESULT "  # the prefix of a worker's result line
TRAIN_LR = 1e-3
TRAIN_LT, TRAIN_LM = 8, 12
DECODE_LT, DECODE_NEW = 6, 4
CASCADE_LT, CASCADE_NEW = 6, 8
REF_LEN = 12  # the cascade's prompt frames
CFM_STEPS, CFG_RATE = 2, 0.7
WAV_TOL = 2e-4  # of the unsharded waveform's peak
LOSS_TOL = 1e-5  # relative


def mesh_shape(n: int):
    """(data, model) for n processes: a 2-D split where n >= 4 is even."""
    return (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)


def default_head_dim(device) -> Optional[int]:
    """None (the JAX configurations' widths) on the CPU; 64 on the card,
    where K1 and K3 take no other head dim."""
    return 64 if torch.device(device).type == "cuda" else None


def rows(data: int) -> int:
    return max(2 * data, 2)


def train_config(model_axis: int) -> IndexTTS2Config:
    """`dryrun_multichip`'s GPT, its widths a multiple of the model axis."""
    m = model_axis
    return IndexTTS2Config(gpt=GPTConfig(
        model_dim=64 * m, layers=2, heads=m if m > 1 else 4, max_mel_tokens=64,
        max_text_tokens=32, number_text_tokens=48 * m, number_mel_codes=24 * m + 2,
        start_mel_token=24 * m, stop_mel_token=24 * m + 1,
        condition_module=ConditionModuleConfig(output_size=32, linear_units=16 * m,
                                               attention_heads=4, num_blocks=1),
        emo_condition_module=ConditionModuleConfig(output_size=32, linear_units=16 * m,
                                                   attention_heads=2, num_blocks=1)))


def decode_config(model_axis: int, head_dim: Optional[int] = None) -> IndexTTS2Config:
    """`_dryrun_sharded_decode`'s GPT: 20 heads of 16 (or `head_dim`)."""
    m, dh = model_axis, head_dim or 16
    return IndexTTS2Config(gpt=GPTConfig(
        model_dim=20 * dh, layers=2, heads=20, max_mel_tokens=32, max_text_tokens=16,
        number_text_tokens=40 * m - 1, number_mel_codes=8 * m,
        start_mel_token=8 * m - 2, stop_mel_token=8 * m - 1,
        condition_module=ConditionModuleConfig(output_size=32, linear_units=16 * m,
                                               attention_heads=4, num_blocks=1),
        emo_condition_module=ConditionModuleConfig(output_size=32, linear_units=16 * m,
                                                   attention_heads=2, num_blocks=1)))


def cascade_config(head_dim: Optional[int] = None) -> IndexTTS2Config:
    """`_dryrun_sharded_cascade`'s configuration: a GPT of 4 heads of 16 and
    a DiT of 4 heads of 8 (both of `head_dim` where it is given)."""
    gpt_dim, dit_dim = 4 * (head_dim or 16), 4 * (head_dim or 8)
    return IndexTTS2Config(
        gpt=GPTConfig(
            model_dim=gpt_dim, layers=2, heads=4, max_mel_tokens=64, max_text_tokens=32,
            number_text_tokens=50, number_mel_codes=36, start_mel_token=34,
            stop_mel_token=35,
            condition_module=ConditionModuleConfig(output_size=32, linear_units=48,
                                                   attention_heads=4, num_blocks=1),
            emo_condition_module=ConditionModuleConfig(output_size=32, linear_units=32,
                                                       attention_heads=2, num_blocks=1)),
        semantic_codec=SemanticCodecConfig(codebook_size=36, hidden_size=1024, codebook_dim=8,
                                           vocos_dim=24, vocos_intermediate_dim=32,
                                           vocos_num_layers=1),
        s2mel=S2MelConfig(
            length_regulator=LengthRegulatorConfig(channels=32, in_channels=1024),
            dit=DiTConfig(hidden_dim=dit_dim, num_heads=4, depth=2, in_channels=80,
                          content_dim=32, style_dim=192),
            wavenet=WaveNetConfig(hidden_dim=32, num_layers=2, kernel_size=5),
            gpt_dims=(gpt_dim, 16, 8, 1024)),
        vocoder=BigVGANConfig(num_mels=80, upsample_rates=(8, 8, 4),
                              upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=16,
                              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
        w2vbert=W2VBertConfig(hidden_size=1024, num_hidden_layers=1, num_attention_heads=4,
                              intermediate_size=64, tap_layer=1,
                              conv_depthwise_kernel_size=7),
        runtime=RuntimeConfig(diffusion_steps=CFM_STEPS, max_mel_tokens=16))


def _seeded(make, seed: int, device):
    """make() under torch.manual_seed(seed), its tensors made on `device`."""
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        with dev:
            return make()


def _tensors(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _greedy(gpt, cfg: IndexTTS2Config, conds: torch.Tensor, text: torch.Tensor, max_new: int):
    """Greedy decode, eager, of full-length text rows: (result, the decode
    state)."""
    from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig

    dec = GPTDecoder(gpt, cfg.gpt, SamplingConfig(do_sample=False))
    B, Lt = text.shape
    arrays = dec.build_text_prompt_arrays(text.cpu().numpy(), np.full(B, Lt), Lt)
    ids, pos, valid = (torch.as_tensor(a, device=conds.device) for a in arrays)
    res = dec.generate(conds, ids, pos, valid, None, max_new=max_new, do_sample=False,
                       eager=True)
    return res, next(iter(dec._states.values()))


def cascade_models(cfg: IndexTTS2Config, device, state_dicts=None, seed: int = 0):
    """The cascade's GPT, S2Mel, RepCodec and BigVGAN, float32, for
    inference on `device`: `state_dicts` loaded (strict), else each
    module's PyTorch initialization from `seed`."""
    from indextts_tpu_torch.models.bigvgan import BigVGAN
    from indextts_tpu_torch.models.repcodec import RepCodec
    from indextts_tpu_torch.models.s2mel import S2Mel
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice

    ctors = {"gpt": lambda: UnifiedVoice(cfg.gpt), "s2mel": lambda: S2Mel(cfg.s2mel),
             "repcodec": lambda: RepCodec(cfg.semantic_codec),
             "bigvgan": lambda: BigVGAN(cfg.vocoder)}
    out = {}
    for i, (name, make) in enumerate(ctors.items()):
        model = _seeded(make, seed + i, device)
        if state_dicts is not None:
            model.load_state_dict(state_dicts[name], strict=True)
        out[name] = model.eval().requires_grad_(False)
    return out


def cascade_inputs(cfg: IndexTTS2Config, B: int) -> Dict[str, np.ndarray]:
    """`_dryrun_sharded_cascade`'s inputs for B rows, drawn in its order
    from default_rng(5): text, conds, the prompt's condition and mel, the
    style and the CFM noise; emovec zeros."""
    rng = np.random.default_rng(5)
    g = cfg.gpt
    text = rng.integers(2, 48, (B, CASCADE_LT))
    out = {"text": text, "text_lens": np.full(B, CASCADE_LT)}
    total = REF_LEN + math.floor(CASCADE_NEW * 1.72)
    f32 = np.float32
    out["conds"] = rng.standard_normal((B, g.condition_num_latent, g.model_dim)).astype(f32)
    out["prompt_condition"] = rng.standard_normal(
        (B, REF_LEN, cfg.s2mel.length_regulator.channels)).astype(f32)
    out["ref_mel"] = rng.standard_normal((B, 80, REF_LEN)).astype(f32)
    out["style"] = rng.standard_normal((B, 192)).astype(f32)
    out["noise"] = rng.standard_normal((B, 80, total)).astype(f32)
    out["emovec"] = np.zeros((B, g.model_dim), f32)
    return out


def run_cascade(models, cfg: IndexTTS2Config, inp: Dict[str, torch.Tensor]) -> dict:
    """decode -> latent -> regulator -> CFM(2) -> vocoder over the rows of
    `inp` (`_dryrun_sharded_cascade`'s post_decode after the decode):
    {"codes", "lengths", "x_lens" (the CFM's valid frames), "wav", "state"
    (the decode's)}."""
    from indextts_tpu_torch.runtime.s2mel_infer import cfm_inference

    gpt, s2mel = models["gpt"], models["s2mel"]
    res, st = _greedy(gpt, cfg, inp["conds"], inp["text"], CASCADE_NEW)
    codes, code_len = res.codes, res.lengths
    target_len = math.floor(CASCADE_NEW * 1.72)
    B = codes.shape[0]
    with torch.inference_mode():
        latent = gpt.forward_latent(inp["conds"], inp["text"], inp["text_lens"], codes, code_len,
                                    inp["emovec"])
        s_infer = models["repcodec"].vq2emb(codes) + s2mel.project_gpt_latent(latent)
        target_lengths = torch.floor(code_len.float() * 1.72).long()
        cond = s2mel.regulate(s_infer, target_lengths, target_len, code_len)
        cat_cond = torch.cat([inp["prompt_condition"], cond], dim=1)
        x_lens = REF_LEN + target_lengths
        prompt_x = torch.zeros((B, 80, REF_LEN + target_len), device=codes.device)
        prompt_x[:, :, :REF_LEN] = inp["ref_mel"]
        mel = cfm_inference(s2mel, cat_cond, x_lens, prompt_x, REF_LEN, inp["style"],
                            inp["noise"], n_steps=CFM_STEPS, cfg_rate=CFG_RATE)
        wav = models["bigvgan"](mel)
    return {"codes": codes, "lengths": code_len, "x_lens": x_lens, "wav": wav, "state": st}


def _k1_case(st) -> dict:
    """The shape (B, local heads, cap, Dh) of a decode state's cache, which
    K1 reads, and the valid length of its last step."""
    return {"k1_shape": list(st.caches[0].shape[1:]),
            "k1_valid": int(st.start) + int(st.step)}


def _counts() -> Dict[str, int]:
    from indextts_tpu_torch.ops import decode_attention, dit_attention, snake

    return {"K1": decode_attention.counter.launches, "K3": dit_attention.counter.launches,
            "K2": snake.counter.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in _counts().items()}


def train_part(mesh, device) -> dict:
    """(a): one GPT step cut over the model axis, rows over the data axis,
    against the one-process step on the global batch."""
    from indextts_tpu_torch import finetune
    from indextts_tpu_torch.parallel.sharding import all_reduce
    from indextts_tpu_torch.runtime import train as T

    data, m = mesh.shape["data"], mesh.shape["model"]
    cfg = train_config(m)
    g, B = cfg.gpt, rows(data)
    rng = np.random.default_rng(0)
    batch = _tensors({
        "spk_latents": rng.standard_normal((B, g.condition_num_latent, g.model_dim)).astype(
            np.float32),
        "text_ids": rng.integers(2, g.number_text_tokens, (B, TRAIN_LT)),
        "text_lens": np.full(B, TRAIN_LT), "mel_codes": rng.integers(
            0, g.start_mel_token, (B, TRAIN_LM)),
        "mel_lens": np.full(B, TRAIN_LM),
        "emovec": rng.standard_normal((B, g.model_dim)).astype(np.float32)}, device)
    whole = T.train_model(cfg, "gpt", device, seed=0)
    sd = {k: v.detach().clone() for k, v in whole.state_dict().items()}
    want = float(T.make_train_step(whole, T.adamw(whole.parameters(), TRAIN_LR))(batch))
    model = T.train_model(cfg, "gpt", device, state_dict=sd, mesh=mesh)
    step = finetune.data_parallel_step("gpt", model, T.adamw(model.parameters(), TRAIN_LR),
                                       mesh)
    loss = float(all_reduce(step(batch).detach().clone(), mesh, axis="data")) / data
    rel = abs(loss - want) / abs(want)
    ok = math.isfinite(loss) and rel <= LOSS_TOL
    print(f"dryrun_multichip {'OK' if ok else 'FAILED'}: mesh=({data},{m}) loss={loss:.6f} "
          f"(one process {want:.6f}, rel {rel:.3g}, tol {LOSS_TOL}); "
          f"{g.heads // m} of {g.heads} heads a rank, {B // data} of {B} rows", flush=True)
    return {"ok": ok, "loss": loss, "loss_one_process": want, "rel": rel}


def decode_part(mesh, device, head_dim: Optional[int]) -> dict:
    """(b): the 20-head GPT's greedy decode cut over the model axis, rows
    over the data axis, gathered, against the unsharded decode."""
    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.parallel.data import local_rows
    from indextts_tpu_torch.parallel.sharding import GPT_PARTITION_RULES, all_gather
    from indextts_tpu_torch.parallel.tp import tensor_parallel

    data, m = mesh.shape["data"], mesh.shape["model"]
    cfg = decode_config(m, head_dim)
    g, B = cfg.gpt, rows(data)
    rng = np.random.default_rng(0)
    inp = _tensors({"text": rng.integers(2, 30, (B, DECODE_LT)), "conds": rng.standard_normal(
        (B, g.condition_num_latent, g.model_dim)).astype(np.float32)}, device)
    make = lambda: UnifiedVoice(g).eval().requires_grad_(False)  # noqa: E731
    want, _ = _greedy(_seeded(make, 0, device), cfg, inp["conds"], inp["text"], DECODE_NEW)
    cut = tensor_parallel(_seeded(make, 0, device), mesh, GPT_PARTITION_RULES)
    local = local_rows(inp, mesh)
    before = _counts()
    res, st = _greedy(cut, cfg, local["conds"], local["text"], DECODE_NEW)
    launches = _since(before)
    codes = all_gather(res.codes, mesh, 0, axis="data")
    ok = torch.equal(codes, want.codes)
    case = _k1_case(st)
    print(f"dryrun sharded decode {'OK' if ok else 'FAILED'}: mesh=({data},{m}) heads={g.heads} "
          f"({case['k1_shape'][1]} a rank, {g.head_dim} wide) codes shape {tuple(codes.shape)} "
          f"tokens==unsharded: {ok}; K1 launches {launches['K1']}", flush=True)
    return {"ok": ok, "codes": codes.tolist(), "launches": launches, **case}


def cascade_part(mesh, device, head_dim: Optional[int]) -> dict:
    """(c): the cascade with rows over the data axis and the GPT and DiT
    cut over the model axis, gathered, against the unsharded cascade."""
    from indextts_tpu_torch.parallel.data import local_rows
    from indextts_tpu_torch.parallel.sharding import (
        DIT_PARTITION_RULES,
        GPT_PARTITION_RULES,
        all_gather,
    )
    from indextts_tpu_torch.parallel.tp import tensor_parallel

    data, m = mesh.shape["data"], mesh.shape["model"]
    cfg = cascade_config(head_dim)
    B = rows(data)
    inp = _tensors(cascade_inputs(cfg, B), device)
    want = run_cascade(cascade_models(cfg, device), cfg, inp)
    models = cascade_models(cfg, device)
    tensor_parallel(models["gpt"], mesh, GPT_PARTITION_RULES)
    tensor_parallel(models["s2mel"], mesh, DIT_PARTITION_RULES)
    before = _counts()
    got = run_cascade(models, cfg, local_rows(inp, mesh))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = _since(before)
    codes = all_gather(got["codes"], mesh, 0, axis="data")
    wav = all_gather(got["wav"].contiguous(), mesh, 0, axis="data")
    peak = float(want["wav"].abs().max())
    max_rel = float((wav - want["wav"]).abs().max()) / (peak + 1e-9)
    same_codes = torch.equal(codes, want["codes"])
    finite = bool(torch.isfinite(wav).all())
    ok = same_codes and finite and peak > 0 and max_rel <= WAV_TOL
    dit = cfg.s2mel.dit
    heads = models["s2mel"].cfm.estimator.transformer.layers[0].attention.h
    print(f"dryrun sharded cascade {'OK' if ok else 'FAILED'}: mesh=({data},{m}) "
          f"decode+latent+regulator+CFM({CFM_STEPS})+vocoder wav {tuple(wav.shape)}; codes equal "
          f"{same_codes}; waveform max diff {max_rel:.3g} of the unsharded peak {peak:.4g} "
          f"(tol {WAV_TOL}); GPT {cfg.gpt.heads // m} of {cfg.gpt.heads} heads and DiT "
          f"{heads} of {dit.num_heads} heads a rank; launches a rank {json.dumps(launches)}",
          flush=True)
    rows_here, frames = got["codes"].shape[0], inp["noise"].shape[-1]
    return {"ok": ok, "codes_equal": same_codes, "max_rel": max_rel, "peak": peak,
            "finite": finite, "launches": launches,
            **_k1_case(got["state"]),
            "k3_shape": [2 * rows_here, heads, frames, dit.head_dim],
            "k3_valid": got["x_lens"].tolist(), "mel_shape": [rows_here, 80, frames]}


def backend_for(n: int, device) -> str:
    """gloo on the CPU, and where n ranks would share a card; NCCL where
    each rank has a card of its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def worker(coord: str, rank: int, n: int, device: str, backend: str) -> dict:
    """One rank: joins the job, builds the mesh, runs (a), (b) and (c)."""
    from indextts_tpu_torch.parallel.sharding import make_mesh

    head_dim = default_head_dim(device)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        # the one-process references are held to float32 sums
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=n, rank=rank)
    try:
        data, m = mesh_shape(n)
        mesh = make_mesh(data, m)
        dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else "cpu"
        out = {"rank": rank, "mesh": [data, m], "backend": backend, "device": str(dev),
               "head_dim": head_dim}
        for name, part in (("train", lambda: train_part(mesh, dev)),
                           ("decode", lambda: decode_part(mesh, dev, head_dim)),
                           ("cascade", lambda: cascade_part(mesh, dev, head_dim))):
            t0 = time.perf_counter()
            out[name] = part()
            out[name]["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device=None, log=print) -> List[dict]:
    """Run the dryrun over n worker processes on `device` (None: the card),
    each within WORKER_TIMEOUT; each worker's output goes to `log`,
    prefixed by its rank. Returns the ranks' results; raises RuntimeError
    if a worker fails, times out or a part does not pass. A worker still
    running at the end is killed."""
    from indextts_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device).type
    head_dim = default_head_dim(dev)
    backend = backend_for(n, dev)
    data, m = mesh_shape(n)
    log(f"dryrun: {n} processes, mesh (data={data}, model={m}), backend {backend} on {dev}"
        + (" (ranks share a card)" if dev == "cuda" and backend == "gloo" else "")
        + f", attention heads {head_dim or 'as the JAX configurations'} wide")
    coord = f"127.0.0.1:{_free_port()}"
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if dev == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "indextts_tpu_torch.parallel.dryrun", "--worker", coord,
           "--procs", str(n), "--device", dev, "--backend", backend]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"dryrun: a worker took more than {WORKER_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results, failed = [], []
    for r, (p, text) in enumerate(zip(procs, logs)):
        result = None
        for line in text.splitlines():
            if line.startswith(RESULT):
                result = json.loads(line[len(RESULT):])
            else:
                log(f"[rank {r}] {line}")
        if p.returncode != 0 or result is None:
            failed.append(f"rank {r} exited {p.returncode}")
            continue
        results.append(result)
        failed += [f"rank {r} part {part}" for part in ("train", "decode", "cascade")
                   if not result[part]["ok"]]
    if failed:
        raise RuntimeError("dryrun failed: " + "; ".join(failed))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=4, help="worker processes (default 4)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="the card (default) or the CPU")
    p.add_argument("--worker", metavar="COORD", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        out = worker(args.worker, args.rank, args.procs, args.device, args.backend)
        print(RESULT + json.dumps(out), flush=True)
        return 0
    try:
        results = dryrun_multichip(args.procs, args.device)
    except RuntimeError as e:
        print(e)
        return 1
    for r in results:
        a = r["train"]
        print(f"rank {r['rank']}: train loss {a['loss']:.6f} (rel {a['rel']:.3g}), decode "
              f"equal {r['decode']['ok']}, cascade codes equal "
              f"{r['cascade']['codes_equal']}, waveform {r['cascade']['max_rel']:.3g} of peak; "
              f"launches (b) {json.dumps(r['decode']['launches'])} (c) "
              f"{json.dumps(r['cascade']['launches'])}")
    print("dryrun OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

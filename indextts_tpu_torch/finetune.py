"""Fine-tuning: training steps, checkpoints and resume, on one card or over
the data axis of several processes.

Counterpart of tools/finetune.py for the port:

  * target `gpt` (UnifiedVoice's text + mel cross-entropy) or `cfm` (the
    s2mel flow-matching step), runtime/train.py, with AdamW as
    `optax.adamw(--lr)`;
  * data: `--data-dir` of .npz batch files (keys = the train-step batch
    keys), or `--synthetic B` random batches at config shapes, drawn by the
    same numpy generator from `--seed` as tools/finetune.py's;
  * parameters: the checkpoint in `--out-dir/latest` when there is one
    (unless `--no-resume`), else `--init-from`, a reference-layout
    checkpoint directory read by the port's loader (runtime/loader.py,
    gpt.pth's text_head kept), else random weights from `--seed`;
  * checkpoints: every `--save-every` steps and at the end, `torch.save`
    of the parameters and of the optimizer's state under
    `--out-dir/latest`, with meta.json holding the step; a resumed run
    continues the step counter.

It runs on the card unless `--device cpu` is given, and prints one JSON
summary line, that of tools/finetune.py, with the real mesh.

Several processes (TARS_COORDINATOR, TARS_NUM_PROCESSES, TARS_PROCESS_ID;
parallel/multihost.py, nccl on the card, gloo on the CPU) train over the
data axis: every rank draws the same global batch (and, for the CFM, the
same noise for the whole of it) and takes its rows of it (parallel/data.py),
the gradients are averaged before AdamW, and the logged loss is the mean
over the ranks. `--batch` must divide over them. Rank 0 writes the
checkpoints; every rank resumes from the same one. `--model-parallel` above 1
(training over the model axis) is not ported yet: ROADMAP.md's item
"training over the model axis".

Examples:
  python -m indextts_tpu_torch.finetune --target gpt --synthetic 8 --steps 50 \\
      --out-dir /ckpts/ft
  python -m indextts_tpu_torch.finetune --target cfm --data-dir batches/ --steps 1000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from indextts_tpu_torch.config import load_config
from indextts_tpu_torch.parallel.data import average_gradients, local_rows
from indextts_tpu_torch.parallel.multihost import global_mesh, maybe_initialize_distributed
from indextts_tpu_torch.parallel.sharding import all_reduce
from indextts_tpu_torch.runtime import train as T
from indextts_tpu_torch.utils.device import resolve_device


def synthetic_gpt_batch(cfg, B, rng):
    g = cfg.gpt
    Lt, Lm = min(24, g.max_text_tokens), min(32, g.max_mel_tokens)
    return {
        "spk_latents": rng.standard_normal(
            (B, g.condition_num_latent, g.model_dim)).astype(np.float32),
        "text_ids": rng.integers(2, g.number_text_tokens, (B, Lt)).astype(np.int32),
        "text_lens": rng.integers(Lt // 2, Lt + 1, (B,)).astype(np.int32),
        "mel_codes": rng.integers(0, g.start_mel_token, (B, Lm)).astype(np.int32),
        "mel_lens": rng.integers(Lm // 2, Lm + 1, (B,)).astype(np.int32),
        "emovec": rng.standard_normal((B, g.model_dim)).astype(np.float32),
    }


def synthetic_cfm_batch(cfg, B, rng):
    T = 64
    d = cfg.s2mel.dit
    return {
        "x1": rng.standard_normal((B, d.in_channels, T)).astype(np.float32),
        "x_lens": rng.integers(T // 2, T + 1, (B,)).astype(np.int32),
        "prompt_lens": rng.integers(4, 12, (B,)).astype(np.int32),
        "mu": rng.standard_normal((B, T, d.content_dim)).astype(np.float32),
        "style": rng.standard_normal((B, d.style_dim)).astype(np.float32),
    }


def batch_stream(args, cfg, B):
    if args.data_dir:
        files = sorted(Path(args.data_dir).glob("*.npz"))
        if not files:
            raise SystemExit(f"no .npz batches under {args.data_dir}")
        i = 0
        while True:
            with np.load(files[i % len(files)]) as z:
                yield {k: z[k] for k in z.files}
            i += 1
    else:
        rng = np.random.default_rng(args.seed)
        make = synthetic_gpt_batch if args.target == "gpt" else synthetic_cfm_batch
        while True:
            yield make(cfg, B, rng)


def to_device(batch, dev) -> T.Batch:
    """numpy batch -> tensors on `dev`: integer arrays as int64 (indices
    and lengths), floating ones as float32."""
    return {k: torch.from_numpy(np.asarray(v)).to(
        dev, torch.int64 if np.issubdtype(np.asarray(v).dtype, np.integer) else torch.float32)
        for k, v in batch.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", choices=["gpt", "cfm"], default="gpt")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--data-dir", default=None,
                    help=".npz batch files (keys = train-step batch keys)")
    ap.add_argument("--synthetic", type=int, default=None, metavar="B",
                    help="random batches of this size at config shapes")
    ap.add_argument("--out-dir", default=None, help="checkpoint dir")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg", default=None, help="config.yaml (default: reference)")
    ap.add_argument("--init-from", default=None,
                    help="reference-layout checkpoint dir to fine-tune from")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.synthetic:
        args.batch = args.synthetic
    return args


def initial_state(args, cfg):
    """The state dict to start from: --init-from's model, else None (random
    weights from --seed)."""
    if not args.init_from:
        return None
    from indextts_tpu_torch.runtime.loader import convert_reference_checkpoints

    name = "gpt" if args.target == "gpt" else "s2mel"
    params, _ = convert_reference_checkpoints(args.init_from, cfg, text_head=True)
    if name not in params:
        raise SystemExit(f"{args.init_from}: no checkpoint for {name}")
    return params[name]


def data_parallel_step(target: str, model, opt, mesh):
    """step(global_batch, generator=None, noise=None) -> this rank's loss:
    one AdamW step on this rank's rows of the global batch, the gradients
    averaged over the mesh's data axis first (parallel/data.py). The CFM's
    noise (t, z, drop) is that of the whole global batch, given or drawn
    from `generator`, and sliced like the rows."""

    def sync(m):
        average_gradients(m.parameters(), mesh)

    if target == "gpt":
        train_step = T.make_train_step(model, opt, grad_sync=sync)
        return lambda glob, generator=None, noise=None: train_step(local_rows(glob, mesh))
    cfm_step = T.make_cfm_train_step(model, opt, grad_sync=sync)

    def step(glob, generator=None, noise=None):
        t, z, drop = T.cfm_noise(glob, generator) if noise is None else noise
        rows = local_rows({"t": t, "z": z} if drop is None else
                          {"t": t, "z": z, "drop": drop}, mesh)
        return cfm_step(local_rows(glob, mesh), noise=(rows["t"], rows["z"], rows.get("drop")))

    return step


def main(argv=None):
    args = parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: training over the model axis is not ported yet "
            "(ROADMAP.md, Queue 1: training over the model axis; the collectives of "
            "parallel/tp.py are not autograd functions)")
    dev = resolve_device(args.device)
    maybe_initialize_distributed(dev)
    mesh = global_mesh(model=args.model_parallel)
    data = mesh.shape["data"]
    if args.batch % data:
        raise SystemExit(f"--batch {args.batch} must be divisible by the data axis ({data} "
                         "processes)")
    rank0 = mesh.rank == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.cfg)

    model = T.train_model(cfg, args.target, dev, initial_state(args, cfg), seed=args.seed)
    opt = T.adamw(model.parameters(), args.lr)
    step0 = 0
    ckpt_dir = Path(args.out_dir) if args.out_dir else None
    latest = ckpt_dir / "latest" if ckpt_dir else None
    if latest and not args.no_resume and (latest / "params.pt").exists():
        model.load_state_dict(torch.load(latest / "params.pt", map_location=dev))
        opt.load_state_dict(torch.load(latest / "opt_state.pt", map_location=dev))
        step0 = int(json.loads((latest / "meta.json").read_text())["step"])
        print(f"resumed from step {step0}", file=sys.stderr)

    run_step = data_parallel_step(args.target, model, opt, mesh)
    stream = batch_stream(args, cfg, args.batch)
    # the CFM noise: seeded with the step the run starts from, so a resumed run
    # does not repeat the noise of the steps before it
    gen = torch.Generator(device=dev).manual_seed(args.seed + step0)
    losses = []
    saved = None
    t_start = time.perf_counter()
    for step in range(step0, step0 + args.steps):
        batch = to_device(next(stream), dev)
        loss = run_step(batch, gen)
        if (step + 1) % args.log_every == 0 or step == step0:
            lv = float(all_reduce(loss.clone(), mesh, axis="data")) / data
            losses.append(lv)
            print(f"step {step + 1}: loss {lv:.4f}", file=sys.stderr)
            if not np.isfinite(lv):
                raise SystemExit(f"non-finite loss at step {step + 1}")
        if latest and (step + 1) % args.save_every == 0:
            saved = save(latest, model, opt, step + 1, rank0)
    if latest and saved != step0 + args.steps:
        save(latest, model, opt, step0 + args.steps, rank0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t_start
    out = {
        "target": args.target,
        "steps": args.steps,
        "from_step": step0,
        "final_step": step0 + args.steps,
        "batch": args.batch,
        "mesh": dict(mesh.shape),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "steps_per_s": round(args.steps / wall, 3),
    }
    print(json.dumps(out))
    return out


def save(latest: Path, model, opt, step: int, write: bool = True) -> int:
    """params.pt, opt_state.pt and meta.json under `latest`, each written
    to a temporary name and renamed, meta.json last, by the rank that
    `write`s (rank 0); the others wait for it. Returns `step`."""
    if not write:
        if dist.is_initialized():
            dist.barrier()
        return step
    latest.mkdir(parents=True, exist_ok=True)
    for name, obj in (("params.pt", model.state_dict()), ("opt_state.pt", opt.state_dict())):
        tmp = latest / f".{name}.tmp"
        torch.save(obj, tmp)
        os.replace(tmp, latest / name)
    tmp = latest / ".meta.json.tmp"
    tmp.write_text(json.dumps({"step": step}) + "\n")
    os.replace(tmp, latest / "meta.json")
    if dist.is_initialized():
        dist.barrier()
    return step


if __name__ == "__main__":
    main()

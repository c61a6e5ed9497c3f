"""Multi-process runtime initialization over torch.distributed.

Counterpart of indextts_tpu/parallel/multihost.py. One process a card (or a
CPU process); `maybe_initialize_distributed()` is called first thing by
every launcher (serve.py, finetune.py). It is a strict no-op when the job
is single-process, so every code path stays correct on one card or the CPU.

Env contract (the JAX package's):
  TARS_COORDINATOR  host:port of process 0 (alias: JAX_COORDINATOR_ADDRESS)
  TARS_NUM_PROCESSES / TARS_PROCESS_ID   the topology (aliases:
      JAX_NUM_PROCESSES / JAX_PROCESS_ID)

torch.distributed discovers nothing itself, so a multi-process job gives
all three: `init_process_group` rendezvouses at tcp://<coordinator> with
the world size and this process's rank.

Backend: "nccl" for a process on the card, "gloo" for one the caller put on
the CPU (`device="cpu"`). Nothing switches from one to the other on its
own: a card that is asked for and missing raises (utils/device.py
`resolve_device`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from indextts_tpu_torch.utils.device import resolve_device

log = logging.getLogger("indextts_tpu_torch.multihost")


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def maybe_initialize_distributed(device=None) -> bool:
    """Initialize torch.distributed if the env describes a multi-process job.

    Returns True if the process group was initialized (now or before),
    False for the single-process fast path (neither TARS_COORDINATOR nor
    TARS_NUM_PROCESSES set, or a process count of 1 or less). `device` is
    the process's device (None: the card), which picks the backend; on the
    card, without an index, the process takes card rank mod the host's card
    count as its current device. Safe to call more than once."""
    if dist.is_initialized():
        return True
    coord = _env("TARS_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
    nproc = _env("TARS_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    pid = _env("TARS_PROCESS_ID", "JAX_PROCESS_ID")
    if coord is None and nproc is None:
        return False
    if nproc is not None and int(nproc) <= 1:
        return False
    if coord is None or nproc is None or pid is None:
        raise ValueError("a multi-process job needs TARS_COORDINATOR, TARS_NUM_PROCESSES and "
                         f"TARS_PROCESS_ID (got {coord!r}, {nproc!r}, {pid!r})")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # one process a card: rank r takes the host's card r mod its count
        torch.cuda.set_device(int(pid) % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=int(nproc),
                            rank=int(pid))
    log.info("torch.distributed initialized (%s): process %d/%d", backend, dist.get_rank(),
             dist.get_world_size())
    return True


def global_mesh(model: int = 1):
    """The (data, model) mesh over every process: data = world / model.
    Each process holds one device, so `model` must divide the world; ranks
    model * d .. model * d + model - 1 form one model group, which a
    launcher keeps on one host by its rank order (the JAX package's rule
    that TP collectives stay inside a host)."""
    from indextts_tpu_torch.parallel.sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model:
        raise ValueError(f"model={model} must divide the {world} processes")
    return make_mesh(data=world // model, model=model)

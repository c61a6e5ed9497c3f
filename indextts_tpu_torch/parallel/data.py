"""Data parallelism over a mesh's `data` axis: each rank takes its rows of
the global batch, and the gradients are averaged with one all_reduce
before the optimizer step, so that every rank keeps the same parameters
(the JAX package's jitted step over a batch sharded P("data"), whose
gradient XLA psums over the axis).

The rows are cut from the batch as it is padded for the whole: the losses
average over every padded position (runtime/train.py `mel_text_loss`), so
padding a rank's rows anew would change the loss. With equal row counts a
rank, the mean of the ranks' mean losses is the global batch's.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from indextts_tpu_torch.parallel.sharding import Mesh, all_reduce


def local_rows(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of every (B, ...) tensor of the global batch: the
    `data` coordinate's B / data rows, in order."""
    n, i = mesh.shape["data"], mesh.coord["data"]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over data={n}")
        b = v.shape[0] // n
        out[k] = v[i * b:(i + 1) * b]
    return out


def average_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> None:
    """Every parameter's gradient replaced by its mean over the data axis:
    the gradients flattened into one buffer, one all_reduce, divided by
    the axis's size and copied back."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or mesh.group("data") is None:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh, axis="data")
    flat /= mesh.shape["data"]
    for g, new in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(new.view_as(g))

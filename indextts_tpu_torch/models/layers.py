"""Small shared layers.

`Linear`, `Conv1d`, `Pointwise` and `LayerNorm` compute in the promoted
dtype of their input and their parameters, as a flax Dense, Conv or
LayerNorm without a `dtype` does: bfloat16 weights under a float32 input
are upcast and the layer computes in float32; a bfloat16 input over
bfloat16 weights stays bfloat16. Where input and parameters share a dtype
nothing is cast. `LayerNorm` takes its statistics and normalizes in
float32 whatever the dtypes, as flax does, and rounds once at the end.
A module whose JAX counterpart computes in a set `dtype` casts its input
to it at its entry (`dtype_of`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def promoted(x: torch.Tensor, *params) -> torch.dtype:
    """The dtype a layer over `params` computes in for the input x."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return dt


def as_dtype(t, dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def dtype_of(module: nn.Module) -> torch.dtype:
    """The dtype of a module's first floating-point parameter."""
    return next(p.dtype for p in module.parameters() if p.is_floating_point())


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x (..., T) padded by `pad` on each side of its last axis, reflected
    as numpy's and jnp.pad's "reflect": F.pad where pad < T, else the
    periodic reflection they continue into (F.pad raises there)."""
    T = x.shape[-1]
    if pad < T:
        return F.pad(x, (pad, pad), mode="reflect")
    if T == 1:
        return x.expand(*x.shape[:-1], T + 2 * pad)
    period = 2 * (T - 1)
    m = torch.arange(-pad, T + pad, device=x.device).remainder(period)
    return x.index_select(-1, torch.where(m >= T, period - m, m))


class Linear(nn.Linear):
    def forward(self, x):
        dt = promoted(x, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), as_dtype(self.bias, dt))


class Conv1d(nn.Conv1d):
    def forward(self, x):
        dt = promoted(x, self.weight)
        return self._conv_forward(x.to(dt), self.weight.to(dt), as_dtype(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        dt = promoted(x, self.weight)
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(dt)


class Pointwise(nn.Module):
    """A kernel-size-1 Conv1d applied channels-last: weight (O, I, 1) as the
    reference stores it, input (..., I) -> (..., O)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1).normal_(std=0.02))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        dt = promoted(x, self.weight)
        return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), as_dtype(self.bias, dt))


class ChannelsLastConv1d(Conv1d):
    """Conv1d (reference weight layout) applied to (B, T, C) input."""

    def forward(self, x):
        return super().forward(x.transpose(1, 2)).transpose(1, 2)

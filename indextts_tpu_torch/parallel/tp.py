"""Tensor parallelism over a mesh's `model` axis.

`tensor_parallel(model, mesh, rules)` cuts a UnifiedVoice (or UnifiedVoiceV1)
by GPT_PARTITION_RULES, or an S2Mel by DIT_PARTITION_RULES, in place: every
tensor becomes this rank's shard (sharding.py `shard_params`), and the
layers around a cut run as the JAX package's SPMD program computes them:

  * a column-cut layer (GPT-2 c_attn and c_fc, the conformer FFN's w_1, the
    DiT's wqkv, w1 and w3) computes its own output columns, no collective;
    c_attn and wqkv hold each of q, k and v for the rank's own heads, so the
    attention runs over `n_head / model` heads (K1 over the decode cache,
    which holds only those heads; K3 in the DiT);
  * a row-cut layer (`RowParallel`: GPT-2 c_proj, the conformer's w_2, the
    DiT's wo and w2) contracts its slice of the input with its rows, one
    all_reduce of the partial sums, then the bias, once. A W8 layer takes
    its activation row scale from an all_reduce(MAX) of the slices' amax
    and reduces the exact int32 partial sums (as float64) before the
    scales, so that it gives the unsharded contraction's bits;
  * a vocabulary-cut embedding (`VocabParallelEmbedding`) looks up the
    rank's rows, zeros elsewhere, and all-reduces;
  * a vocabulary-cut head (`GatherColumns`: mel_head, text_head) gathers
    its columns, so that every rank sees the whole row of logits (top-k,
    the penalty, the typical filter and the stop ban read all of it).

A rule that does not divide leaves its layer whole on every rank (a
replicated layer needs nothing). A layer that a rule cuts is wrapped even
at a model axis of 1, so that the wrapped path runs (and reduces over a
group of one) in a one-rank mesh too. W8 runs the plain contraction (the
JAX package's gemv_impl "xla", as its TP test does); the GEMV kernels and
W4 blocks (whose attn c_proj the rules replicate) are not cut and raise.

Training over the model axis is not here: the collectives are not
autograd functions.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.models.conformer import ConformerFFN
from indextts_tpu_torch.models.gpt2 import (
    Conv1D,
    GPT2Attention,
    GPT2MLP,
    QConv1D,
    QuantDenseHead,
    w8a8,
)
from indextts_tpu_torch.models.layers import promoted
from indextts_tpu_torch.models.s2mel import DiTAttention, DiTFeedForward
from indextts_tpu_torch.parallel.sharding import (
    Mesh,
    all_gather_last,
    all_reduce,
    placement,
    shard_params,
)


def _plain(layer: nn.Module) -> nn.Module:
    """`layer`, unless it is a quantized layer that a cut cannot take: W4
    (the rules leave its attn c_proj whole) or one on the GEMV kernels, whose
    launch plans hold the unsharded widths."""
    if isinstance(layer, QConv1D) and (layer.wbits != 8 or layer.gemv):
        raise NotImplementedError("tensor parallelism cuts W8 layers on the plain "
                                  "contraction (gemv_impl 'xla') only")
    return layer


class RowParallel(nn.Module):
    """A layer whose contraction axis is cut over the model axis: a Conv1D,
    a Linear, or a W8 QConv1D on the plain route."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = _plain(inner), mesh

    def forward(self, x):
        inner, mesh = self.inner, self.mesh
        if isinstance(inner, QConv1D):
            # the whole row's amax over every slice; the exact integer sums
            # reduced before the scales
            amax = all_reduce(x.float().abs().amax(dim=-1, keepdim=True), mesh,
                              op=dist.ReduceOp.MAX)
            return w8a8(x, inner.weight_q, inner.weight_scale, inner.bias, amax,
                        lambda acc: all_reduce(acc, mesh)).to(x.dtype)
        if isinstance(inner, Conv1D):
            return all_reduce(torch.matmul(x, inner.weight), mesh) + inner.bias
        dt = promoted(x, inner.weight)
        y = all_reduce(F.linear(x.to(dt), inner.weight.to(dt)), mesh)
        return y if inner.bias is None else y + inner.bias.to(dt)


class VocabParallelEmbedding(nn.Module):
    """An embedding whose rows [offset, offset + rows) this rank holds."""

    def __init__(self, inner: nn.Embedding, mesh: Mesh, offset: int):
        super().__init__()
        self.inner, self.mesh, self.offset = inner, mesh, offset

    @property
    def weight(self) -> torch.Tensor:
        return self.inner.weight

    def forward(self, ids):
        w = self.inner.weight
        local = ids - self.offset
        inside = (local >= 0) & (local < w.shape[0])
        out = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        out = torch.where(inside[..., None], out, torch.zeros((), dtype=w.dtype, device=w.device))
        return all_reduce(out, self.mesh)


class GatherColumns(nn.Module):
    """A head whose output columns are cut: the columns gathered in rank
    order (a QuantDenseHead's padding columns sliced off after)."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = _plain(inner), mesh

    def forward(self, x):
        inner = self.inner
        if isinstance(inner, QuantDenseHead):
            return all_gather_last(QConv1D.forward(inner, x), self.mesh)[..., :inner.features]
        return all_gather_last(inner(x), self.mesh)


def _cut_names(state_dict, mesh: Mesh, rules) -> set:
    """The tensors a rule cuts on this mesh (at any model size)."""
    return {name for name, t in state_dict.items()
            if any(a is not None for a in placement(name, t.shape, mesh, rules)[0].axes)}


def _install(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Put `t` in place of the parameter or buffer `name`."""
    owner, _, attr = name.rpartition(".")
    mod = model.get_submodule(owner)
    old = getattr(mod, attr)
    if isinstance(old, nn.Parameter):
        setattr(mod, attr, nn.Parameter(t.contiguous(), requires_grad=old.requires_grad))
    else:
        mod._buffers[attr] = t.contiguous()


def _weight_name(prefix: str, layer: nn.Module) -> str:
    if isinstance(layer, QConv1D):
        return f"{prefix}.weight_q4" if layer.wbits == 4 else f"{prefix}.weight_q"
    return f"{prefix}.weight"


def tensor_parallel(model: nn.Module, mesh: Mesh, rules) -> nn.Module:
    """Cut `model` over `mesh`'s model axis in place by `rules` (see the
    module's docstring); returns it, with `model.mesh` set."""
    full = model.state_dict()
    cut = _cut_names(full, mesh, rules)
    for name, t in shard_params(full, mesh, rules).items():
        if name in cut:
            _install(model, name, t)
    m, i = mesh.shape["model"], mesh.coord["model"]

    def is_cut(prefix, layer):
        return _weight_name(prefix, layer) in cut

    def local_heads(prefix, heads):
        if heads % m:
            raise ValueError(f"{prefix}: {heads} heads do not divide over model={m}")
        return heads // m

    for prefix, mod in list(model.named_modules()):
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, GPT2Attention) and is_cut(pre + "c_attn", mod.c_attn):
            mod.n_head = local_heads(prefix, mod.n_head)
            mod.c_proj = RowParallel(mod.c_proj, mesh)
        elif isinstance(mod, DiTAttention) and is_cut(pre + "wqkv", mod.wqkv):
            mod.h = local_heads(prefix, mod.h)
            mod.wo = RowParallel(mod.wo, mesh)
        elif isinstance(mod, GPT2MLP) and is_cut(pre + "c_fc", mod.c_fc):
            mod.c_proj = RowParallel(mod.c_proj, mesh)
        elif isinstance(mod, DiTFeedForward) and is_cut(pre + "w1", mod.w1):
            mod.w2 = RowParallel(mod.w2, mesh)
        elif isinstance(mod, ConformerFFN) and is_cut(pre + "w_1", mod.w_1):
            # the rules leave w_1's bias whole (JAX's SPMD adds it globally):
            # this rank adds its own columns' part
            _install(model, pre + "w_1.bias", mod.w_1.bias.detach().chunk(m)[i].clone())
            mod.w_2 = RowParallel(mod.w_2, mesh)
    for name in ("text_embedding", "mel_embedding"):
        if f"{name}.weight" in cut:
            emb = getattr(model, name)
            setattr(model, name, VocabParallelEmbedding(emb, mesh, i * emb.weight.shape[0]))
    for name in ("mel_head", "text_head"):
        head = getattr(model, name, None)
        if head is not None and _weight_name(name, head) in cut:
            setattr(model, name, GatherColumns(head, mesh))
    model.mesh = mesh
    return model

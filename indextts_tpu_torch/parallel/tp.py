"""Tensor parallelism over a mesh's `model` axis, for inference and for
training.

`tensor_parallel(model, mesh, rules)` cuts a UnifiedVoice (or UnifiedVoiceV1)
by GPT_PARTITION_RULES, or an S2Mel by DIT_PARTITION_RULES, in place: every
tensor becomes this rank's shard (sharding.py `shard_params`), and the
layers around a cut run as the JAX package's SPMD program computes them:

  * a column-cut layer (GPT-2 c_attn and c_fc, the conformer FFN's w_1, the
    DiT's wqkv, w1 and w3) computes its own output columns, no collective;
    c_attn and wqkv hold each of q, k and v for the rank's own heads, so the
    attention runs over `n_head / model` heads (K1 over a float decode
    cache, K4 over an int8 one, each holding only those heads; K3 in the
    DiT, and K3 with its statistics, K9 and K10 when it trains);
  * a row-cut layer (`RowParallel`: GPT-2 c_proj, the conformer's w_2, the
    DiT's wo and w2) contracts its slice of the input with its rows, one
    all_reduce of the partial sums, then the bias, once;
  * a vocabulary-cut embedding (`VocabParallelEmbedding`) looks up the
    rank's rows, zeros elsewhere, and all-reduces;
  * a vocabulary-cut head (`GatherColumns`: mel_head, text_head) gathers
    its columns, so that every rank sees the whole row of logits (top-k,
    the penalty, the typical filter and the stop ban read all of it).

The quantized GPT (models/gpt2.py: W8 or W4 blocks, the int8 head), as the
JAX rules place its blocks. On the plain contraction:

  * c_attn (int8, or W4 packed along its rows) is cut by heads and c_fc by
    hidden columns, each unpacking and contracting its own block;
  * the W8 attn c_proj and the mlp c_proj (W4: packed along its output
    columns, so its rows cut) are row-cut: the row's activation scale
    comes from an all_reduce(MAX) of the slices' amax, and the exact int32
    partial sums are reduced (as float64) before the scales;
  * the W4 attn c_proj is replicated, its packed pairs (i, i + D/2)
    interleaving the heads' shards: `GatherHeads` gathers the ranks'
    attention outputs in head order and runs the whole layer on every
    rank, no reduce.

So every cut layer gives the unsharded bits, and the cut GPT the unsharded
codes. On a `gemv` GPT's single-token decode calls the layers take their
kernels at the rank's own widths, where the JAX gating opens them there:

  * c_attn takes K5 (W8) or K7 (W4) over its local columns (1920 of 3840
    at D=1280, model=2);
  * the W8 attn c_proj takes K5 over its slice of the rows (640 of 1280),
    quantized with the whole row's scale; the W4 one K7 over all of them
    after the gather;
  * the fused MLP (K6 or K8) runs over the rank's hidden slice, its hidden
    quantized in groups of the whole MLP's width (models/gpt2.py
    GPT2MLP.group; 512 at D=1280, 5 of 10 groups a rank): a slice that is
    not a whole number of groups raises ValueError;
  * the int8 head's local columns (4160 of 8320) close K5's gate, so they
    take the plain contraction, as one process would at that width.

A row-cut kernel's float output and the fused MLP's are summed over the
model group, the first rank's carrying the bias (`RowParallel.bias`), so these differ from the
unsharded results by float rounding: the sums run in another order
(tests/test_torch_parallel.py and chip_smoke.py state the tolerance on the
logits). The launch plans (ops/gemv.py gemv_plan, mlp_rows) follow the
local weights.

Training goes through the same layers, with Megatron's f and g around each
cut (sharding.py): f (`copy_to_model`, identity forward, all_reduce of the
gradient) on the input of every module that holds a column-cut layer, one
f for GPT-2's attention and its MLP, the DiT's attention and its FFN (w1
and w3 share it), the conformer FFN and each head; g (`reduce_from_model`)
is the all_reduce of RowParallel and of the embedding. Without f, the
gradient reaching a replicated activation would be this rank's columns'
part only, and the LayerNorms, positional embeddings and everything before
them would train on partial sums. Every replicated parameter thus gets the
whole gradient on every rank of a model group; a cut one its own piece's.
Outside autograd f and g are the plain collectives, so inference keeps its
bits. The quantized layers are inference only.

A rule that does not divide leaves its layer whole on every rank (a
replicated layer needs nothing). A layer that a rule cuts is wrapped even
at a model axis of 1, so that the wrapped path runs (and reduces over a
group of one, which sums nothing: the unsharded bits on every route) in a
one-rank mesh too. The wrappers move a layer's tensors under
`<layer>.inner.`: `full_state` maps a cut model's tensors (its state, its
gradients, its optimizer's moments) back to the unwrapped names and
gathers them over the model axis (sharding.py `unshard_params`), and
`local_state` cuts a full state for the cut model, so that checkpoints keep
the full layout.
"""

from __future__ import annotations

from typing import Dict

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
    quant_row,
    w8a8,
)
from indextts_tpu_torch.models.layers import promoted
from indextts_tpu_torch.models.s2mel import DiTAttention, DiTFeedForward
from indextts_tpu_torch.parallel.sharding import (
    Mesh,
    P,
    all_gather,
    all_reduce,
    copy_to_model,
    cut_layout,
    gather_from_model,
    local_piece,
    reduce_from_model,
    shard_params,
    unshard_params,
)


class RowParallel(nn.Module):
    """A layer whose contraction axis is cut over the model axis: a Conv1D,
    a Linear, or a QConv1D (W8, or W4 packed along its columns)."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = inner, mesh

    # a QConv1D's weights, which a cut MLP's fused kernel reads
    # (models/gpt2.py GPT2MLP)
    stored_weight = property(lambda self: self.inner.stored_weight)
    weight_scale = property(lambda self: self.inner.weight_scale)

    @property
    def bias(self) -> torch.Tensor:
        """The bias of this rank's partial output, where the ranks' float
        outputs are summed (K5, the fused MLP): the inner layer's on the
        model group's first rank, zeros on the others, so that the sum adds
        it once."""
        bias = self.inner.bias
        return bias if self.mesh.coord["model"] == 0 else torch.zeros_like(bias)

    def forward(self, x):
        inner, mesh = self.inner, self.mesh
        if isinstance(inner, QConv1D):
            # the whole row's amax over every slice
            amax = all_reduce(x.float().abs().amax(dim=-1, keepdim=True), mesh,
                              op=dist.ReduceOp.MAX)
            rows = inner.kernel_rows(x)
            if rows:
                # K5 over the slice; the ranks' float outputs summed
                x_q, a = quant_row(x.reshape(rows, inner.nx), amax.reshape(rows, 1))
                y = all_reduce(inner.kernel(x_q, a, self.bias), mesh)
                return y.reshape(*x.shape[:-1], inner.nf).to(x.dtype)
            # the exact integer sums reduced before the scales
            return w8a8(x, inner.int8_weight(), inner.weight_scale, inner.bias, amax,
                        lambda acc: all_reduce(acc, mesh)).to(x.dtype)
        if isinstance(inner, Conv1D):
            return reduce_from_model(torch.matmul(x, inner.weight), mesh) + inner.bias
        dt = promoted(x, inner.weight)
        y = reduce_from_model(F.linear(x.to(dt), inner.weight.to(dt)), mesh)
        return y if inner.bias is None else y + inner.bias.to(dt)


class GatherHeads(nn.Module):
    """A layer that the rules leave whole behind a head-cut attention (the
    W4 attn c_proj): the ranks' attention outputs gathered in head order,
    then the whole layer on every rank, no reduce."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = inner, mesh

    def forward(self, x):
        return self.inner(gather_from_model(x, self.mesh))


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
        return reduce_from_model(out, self.mesh)


class GatherColumns(nn.Module):
    """A head whose output columns are cut: the columns gathered in rank
    order (a QuantDenseHead's padding columns sliced off after), with f on
    its input."""

    def __init__(self, inner: nn.Module, mesh: Mesh):
        super().__init__()
        self.inner, self.mesh = inner, mesh

    def forward(self, x):
        inner = self.inner
        if isinstance(inner, QuantDenseHead):
            return all_gather(QConv1D.forward(inner, x), self.mesh, -1)[..., :inner.features]
        return gather_from_model(inner(copy_to_model(x, self.mesh)), self.mesh)


def _copy_input(mesh: Mesh):
    """A forward pre-hook that puts f (`copy_to_model`) on a module's first
    argument."""

    def hook(module, args):
        return (copy_to_model(args[0], mesh),) + tuple(args[1:])

    return hook


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
    layout = cut_layout(full, mesh, rules)
    m, i = mesh.shape["model"], mesh.coord["model"]

    def is_cut(prefix, layer):
        return _weight_name(prefix, layer) in layout

    for prefix, mod in model.named_modules():
        # the fused MLP's hidden groups are the whole MLP's
        if isinstance(mod, GPT2MLP) and mod.group and is_cut(f"{prefix}.c_fc", mod.c_fc) \
                and mod.c_fc.nf // m % mod.group:
            raise ValueError(f"{prefix}: a hidden slice of {mod.c_fc.nf // m} columns "
                             f"(model={m}) is not a whole number of the fused MLP's groups "
                             f"of {mod.group}")
    for name, t in shard_params(full, mesh, rules).items():
        if name in layout:
            _install(model, name, t)

    def local_heads(prefix, heads):
        if heads % m:
            raise ValueError(f"{prefix}: {heads} heads do not divide over model={m}")
        return heads // m

    wrapped = []
    for prefix, mod in list(model.named_modules()):
        pre = f"{prefix}." if prefix else ""
        if isinstance(mod, GPT2Attention) and is_cut(pre + "c_attn", mod.c_attn):
            mod.n_head = local_heads(prefix, mod.n_head)
            row = pre + "c_proj"
            mod.c_proj = (RowParallel if is_cut(row, mod.c_proj) else GatherHeads)(
                mod.c_proj, mesh)
        elif isinstance(mod, DiTAttention) and is_cut(pre + "wqkv", mod.wqkv):
            mod.h = local_heads(prefix, mod.h)
            mod.wo, row = RowParallel(mod.wo, mesh), pre + "wo"
        elif isinstance(mod, GPT2MLP) and is_cut(pre + "c_fc", mod.c_fc):
            mod.c_proj, row = RowParallel(mod.c_proj, mesh), pre + "c_proj"
            mod.reduce = lambda y: all_reduce(y, mesh)
        elif isinstance(mod, DiTFeedForward) and is_cut(pre + "w1", mod.w1):
            mod.w2, row = RowParallel(mod.w2, mesh), pre + "w2"
        elif isinstance(mod, ConformerFFN) and is_cut(pre + "w_1", mod.w_1):
            # the rules leave w_1's bias whole (JAX's SPMD adds it globally):
            # this rank adds its own columns' part, a parameter of its own
            _install(model, pre + "w_1.bias", mod.w_1.bias.detach().chunk(m)[i].clone())
            layout[pre + "w_1.bias"] = P("model")
            mod.w_2, row = RowParallel(mod.w_2, mesh), pre + "w_2"
        else:
            continue
        mod.register_forward_pre_hook(_copy_input(mesh))
        wrapped.append(row)
    for name in ("text_embedding", "mel_embedding"):
        if f"{name}.weight" in layout:
            emb = getattr(model, name)
            setattr(model, name, VocabParallelEmbedding(emb, mesh, i * emb.weight.shape[0]))
            wrapped.append(name)
    for name in ("mel_head", "text_head"):
        head = getattr(model, name, None)
        if head is not None and _weight_name(name, head) in layout:
            setattr(model, name, GatherColumns(head, mesh))
            wrapped.append(name)
    model.mesh, model.tp_layout = mesh, layout
    model.tp_names = {name: _unwrapped(name, wrapped) for name in model.state_dict()}
    return model


def _unwrapped(name: str, wrapped) -> str:
    """`name` of a cut model's tensor with the `.inner` of its wrapper (at
    one of the `wrapped` prefixes) taken out."""
    for prefix in wrapped:
        if name.startswith(prefix + ".inner."):
            return prefix + name[len(prefix) + len(".inner"):]
    return name


def full_name(model: nn.Module, name: str) -> str:
    """The unwrapped name of a (possibly cut) model's tensor `name`."""
    return getattr(model, "tp_names", {}).get(name, name)


def full_state(model: nn.Module, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`named`, tensors under a cut model's names (its state dict, its
    gradients, its optimizer's moments), in the full layout: under the
    unwrapped names, each cut tensor gathered over the model axis. A
    collective: every rank of the model group calls it with the same names.
    A model that tensor_parallel did not cut gets `named` back."""
    names = getattr(model, "tp_names", None)
    if names is None:
        return dict(named)
    return unshard_params({names[k]: v for k, v in named.items()}, model.mesh,
                          model.tp_layout)


def local_state(model: nn.Module, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of `full_state`: tensors of the full layout cut to this
    rank's pieces, under the cut model's names."""
    names = getattr(model, "tp_names", None)
    if names is None:
        return dict(full)
    back = {v: k for k, v in names.items()}
    return {back[name]: local_piece(t, model.tp_layout.get(name, P()), model.mesh)
            for name, t in full.items()}

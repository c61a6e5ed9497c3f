"""Mesh construction, the collectives over one of its axes (`all_reduce`,
`all_gather_last`) and parameter partition rules.

Counterpart of indextts_tpu/parallel/sharding.py: one 2-D mesh (data,
model) of processes, one device each.
  * data  - utterance batches; gradients all-reduced over it.
  * model - tensor parallelism: GPT-2 attention and MLP column + row
    sharding (c_attn / c_fc outputs cut, c_proj inputs cut, one all_reduce
    a c_proj), the vocabulary axis of the big embeddings and the heads.

A rank is `data_index * model + model_index`; `make_mesh` builds the
torch.distributed group of each axis that holds this rank. Everything
degrades to (1, 1) in one process, where no collective runs.

The rule tables are the JAX package's, rule for rule and in its order
(first match wins, the default is replicated), written against the port's
state_dict names (weights.py) and in the port's orientation: GPT-2 Conv1D
weights are (in, out) in both packages; nn.Linear weights (the logits and
text heads, the conformers' and the DiT's projections) are (out, in), so
a JAX kernel's P(None, "model") is P("model", None) here and the other way
round. A spec with `parts=3` cuts a fused [q | k | v] axis: each third is cut
by heads and a rank holds its piece of each third, concatenated, where the
JAX package's SPMD semantics cut the fused axis in contiguous pieces and
stay global (a contiguous cut would give one rank all of q and half of k).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

@dataclass(frozen=True, init=False)
class P:
    """A partition spec: for each tensor axis, the mesh axis it is cut over
    or None; `parts` equal blocks along the cut axis, each cut alike."""

    axes: Tuple[Optional[str], ...]
    parts: int = 1

    def __init__(self, *axes: Optional[str], parts: int = 1):
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "parts", parts)


class Mesh:
    """The (data, model) layout of `data * model` ranks, this process's
    `rank` and coordinates in it, and the process group of each axis that
    holds this rank (`groups`; none in one process, where collectives are
    skipped)."""

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0):
        if not 0 <= rank < data * model:
            raise ValueError(f"rank {rank} is outside the ({data}, {model}) mesh")
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.coord = {"data": rank // model, "model": rank % model}
        self.groups: Dict[str, object] = {}

    def group(self, axis: str):
        return self.groups.get(axis)

    def ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's group along `axis`, in order."""
        other = "data" if axis == "model" else "model"
        return group_ranks(self.shape["data"], self.shape["model"], axis, self.coord[other])

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def group_ranks(data: int, model: int, axis: str, index: int) -> List[int]:
    """The ranks of group `index` along `axis` of a (data, model) mesh: a
    model group is a row of `model` consecutive ranks, a data group a
    column."""
    if axis == "model":
        return [index * model + m for m in range(model)]
    return [d * model + index for d in range(data)]


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the first data * model ranks of the
    initialized process group, with the groups of both axes (every rank
    takes part in creating every group, as torch.distributed asks).
    Without an initialized group only (1, 1) exists."""
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a ({data}, {model}) mesh needs torch.distributed initialized "
                             f"with {n} processes")
        return Mesh(1, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n:
        raise ValueError(f"need {n} processes, have {world}")
    mesh = Mesh(data, model, rank)
    for axis, count in (("model", data), ("data", model)):
        for index in range(count):
            ranks = group_ranks(data, model, axis, index)
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axis] = group
    return mesh


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "model",
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced in place over this rank's group along `axis` (nothing in a
    mesh without groups)."""
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_last(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The group's tensors concatenated along the last axis, in rank order."""
    group = mesh.group(axis)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-1)


_H = r"^gpt\.h\.\d+\."

# the UnifiedVoice state dict; first match wins, default replicated
GPT_PARTITION_RULES = [
    # W4 packed-nibble layout (QConv1D wbits=4, weight_q4), before the
    # weight_q rules:
    #   * c_attn / c_fc pack CONTRACTION rows (in/2, out); the unpacked
    #     output axis is cut.
    #   * attn c_proj packs its contraction rows too, pairs (i, i + d/2) that
    #     interleave the head shards: replicated, as in JAX.
    #   * mlp c_proj packs OUTPUT columns (in, out/2); its contraction axis
    #     is cut like the float kernel's.
    (_H + r"attn\.c_attn\.weight_q4$", P(None, "model", parts=3)),
    (_H + r"attn\.c_proj\.weight_q4$", P()),
    (_H + r"mlp\.c_fc\.weight_q4$", P(None, "model")),
    (_H + r"mlp\.c_proj\.weight_q4$", P("model", None)),
    # W8 (weight_q (in, out), weight_scale per output channel): the scale
    # follows the output axis of a column-cut layer and is whole for a
    # row-cut one, whose outputs are all-reduced to full width
    (_H + r"attn\.c_attn\.weight_q$", P(None, "model", parts=3)),
    (_H + r"attn\.c_attn\.weight_scale$", P("model", parts=3)),
    (_H + r"attn\.c_proj\.weight_q$", P("model", None)),
    (_H + r"attn\.c_proj\.weight_scale$", P()),
    (_H + r"mlp\.c_fc\.weight_q$", P(None, "model")),
    (_H + r"mlp\.c_fc\.weight_scale$", P("model")),
    (_H + r"mlp\.c_proj\.weight_q$", P("model", None)),
    (_H + r"mlp\.c_proj\.weight_scale$", P()),
    # GPT-2 blocks: column-cut fused qkv and MLP up, row-cut projections
    (_H + r"attn\.c_attn\.weight$", P(None, "model", parts=3)),
    (_H + r"attn\.c_attn\.bias$", P("model", parts=3)),
    (_H + r"attn\.c_proj\.weight$", P("model", None)),
    (_H + r"mlp\.c_fc\.weight$", P(None, "model")),
    (_H + r"mlp\.c_fc\.bias$", P("model")),
    (_H + r"mlp\.c_proj\.weight$", P("model", None)),
    # big embeddings and heads: the vocabulary axis
    (r"^text_embedding\.weight$", P("model", None)),
    (r"^mel_embedding\.weight$", P("model", None)),
    # int8 head (QuantDenseHead, (in, out) padded to 128 columns): columns
    (r"^mel_head\.weight_q$", P(None, "model")),
    (r"^mel_head\.weight_scale$", P("model")),
    (r"^mel_head\.weight$", P("model", None)),
    (r"^mel_head\.bias$", P("model")),
    (r"^text_head\.weight$", P("model", None)),
    (r"^text_head\.bias$", P("model")),
    # conformer FFNs (small; the hidden axis anyway)
    (r"feed_forward\.w_1\.weight$", P("model", None)),
    (r"feed_forward\.w_2\.weight$", P(None, "model")),
]

_L = r"transformer\.layers\.\d+\."

# the S2Mel state dict (cfm.estimator.transformer.layers.{i}...)
DIT_PARTITION_RULES = [
    (_L + r"attention\.wqkv\.weight$", P("model", None, parts=3)),
    (_L + r"attention\.wo\.weight$", P(None, "model")),
    (_L + r"feed_forward\.w1\.weight$", P("model", None)),
    (_L + r"feed_forward\.w3\.weight$", P("model", None)),
    (_L + r"feed_forward\.w2\.weight$", P(None, "model")),
]


def spec_for_name(name: str, rules) -> P:
    for pat, spec in rules:
        if re.search(pat, name):
            return spec
    return P()


def placement(name: str, shape, mesh: Mesh, rules) -> Tuple[P, List[str]]:
    """The spec that applies to tensor `name` of `shape` on `mesh`: the
    rule's, each axis that does not divide (by parts x the mesh axis)
    replaced by None; and a note for each such axis."""
    spec = spec_for_name(name, rules)
    fixed, dropped = [], []
    for i, axis in enumerate(spec.axes):
        size = mesh.shape[axis] if axis is not None else 1
        if axis is None or (i < len(shape) and shape[i] % (spec.parts * size) == 0):
            fixed.append(axis)
        else:
            fixed.append(None)
            dropped.append(f"{name}: shape {tuple(shape)} axis {i} !% {spec.parts} x "
                           f"{axis}={size}")
    return P(*fixed, parts=spec.parts), dropped


def cut(t: torch.Tensor, dim: int, parts: int, size: int, index: int) -> torch.Tensor:
    """Piece `index` of `size` of each of `parts` equal blocks of t along
    `dim`, the pieces concatenated."""
    blocks = t.chunk(parts, dim=dim)
    return torch.cat([b.chunk(size, dim=dim)[index] for b in blocks], dim=dim)


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh, rules,
                 strict: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's shard of every tensor of `state_dict` by the rules: a cut
    axis holds the rank's piece along its mesh axis (`cut`, a copy), a
    replicated tensor is the tensor itself. A rule whose axis does not divide
    is replicated instead; with `strict` that raises, listing every such
    axis."""
    out, dropped = {}, []
    for name, t in state_dict.items():
        spec, notes = placement(name, t.shape, mesh, rules)
        dropped += notes
        for dim, axis in enumerate(spec.axes):
            if axis is not None:
                t = cut(t, dim, spec.parts, mesh.shape[axis], mesh.coord[axis])
        out[name] = t
    if dropped and strict:
        raise ValueError("partition rules dropped (axis not divisible by mesh):\n  "
                         + "\n  ".join(dropped))
    return out

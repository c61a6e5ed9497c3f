"""Qwen3 causal LM: the backbone of the text-to-emotion model.

Counterpart of indextts_tpu/models/qwen3.py (the reference's QwenEmotion
loads transformers' Qwen3ForCausalLM from the fine-tuned Qwen3-0.6B
checkpoint `qwen0.6bemo4-merge`): RMSNorm in float32 (eps 1e-6), per-head
q/k norms before RoPE, rotate-half RoPE (theta 1e6), grouped-query
attention (each KV head serves H / KV query heads, as `jnp.repeat` along
the head axis), SwiGLU, and the head tied to the token embedding, computed
over float32 hidden states. Masks add -1e9.

Parameter names are the Hugging Face checkpoint's keys
(`model.embed_tokens.weight`, `model.layers.{i}.self_attn.q_proj.weight`,
...), so `Qwen3LM.load_state_dict` takes such a state dict as it is, with
its `model.` prefix or without it (as indextts_tpu/runtime/torch_convert.py
`convert_qwen3` reads it); a tied `lm_head.weight` is dropped.

`QwenDecoder` decodes greedily as the JAX `greedy_generate` does: an eager
prefill, then one step a token over a static KV cache of `cache_cap(S,
max_new)` slots, masked by the valid length. On the card the step is one
CUDA graph per cache capacity (the counterpart of the JAX package's jitted
`step`): the token, position and valid length live in 0-d device buffers
that the step advances itself, RoPE's angles are computed on the device
from the position, and the argmax stays on the device; the host reads one
token back a step to stop at eos. The CPU runs the same step eagerly. The
cache is written in place.
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from indextts_tpu_torch.config import QwenEmoConfig
from indextts_tpu_torch.ops import cuda_lib
from indextts_tpu_torch.runtime.decode import cache_cap

NEG_INF = -1e9
# cache capacities whose buffers and captured steps a decoder keeps
MAX_CAPS = 4


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 over the last axis, cast back to x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight, eps).to(x.dtype)


class QwenRMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE's tables (T, head_dim) for positions (T,), computed on their
    device from the JAX tables c = cos, s = sin (T, head_dim / 2): [c, c]
    and [-s, s]."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions[:, None].float() * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rope_halved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE (halves, not interleaved pairs) of x (B, T, H, D)
    with `rope_tables`' (T, D): [x1, x2] -> [x1 c - x2 s, x2 c + x1 s], as
    x * [c, c] + [x2, x1] * [-s, s]."""
    swapped = torch.roll(x, x.shape[-1] // 2, dims=-1)
    return torch.addcmul(x * cos[None, :, None, :], swapped, sin[None, :, None, :])


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(..., KV, T, D) -> (..., KV * rep, T, D), head h a copy of KV head
    h // rep (`jnp.repeat` along the head axis)."""
    *lead, kv, t, d = x.shape
    return x.unsqueeze(-3).expand(*lead, kv, rep, t, d).reshape(*lead, kv * rep, t, d)


class Qwen3Attention(nn.Module):
    def __init__(self, c: QwenEmoConfig):
        super().__init__()
        self.c = c
        H, KV, Dh = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.q_proj = nn.Linear(c.hidden_size, H * Dh, bias=False)
        self.k_proj = nn.Linear(c.hidden_size, KV * Dh, bias=False)
        self.v_proj = nn.Linear(c.hidden_size, KV * Dh, bias=False)
        self.o_proj = nn.Linear(H * Dh, c.hidden_size, bias=False)
        self.q_norm = QwenRMSNorm(Dh, c.rms_norm_eps)
        self.k_norm = QwenRMSNorm(Dh, c.rms_norm_eps)

    def forward(self, x, positions, cos, sin, bias, cache=None):
        """x (B, T, hidden); `bias` (B * H or 1, T or 1, S), 0 or -1e9,
        added to the scores. Without `cache`, attends over these T tokens
        and returns their K, V (B, KV, T, Dh). With `cache` (K, V each (B,
        H, cap, Dh): a KV head stored once for each of its H / KV query
        heads, so that a step reads it without a copy), writes the tokens'
        K, V at slots `positions` and attends over the cache, which it
        returns. Query head h reads KV head h // (H / KV), as `jnp.repeat`
        gives it."""
        c = self.c
        B, T, _ = x.shape
        H, KV, Dh = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        q = self.q_norm(self.q_proj(x).view(B, T, H, Dh))
        k = self.k_norm(self.k_proj(x).view(B, T, KV, Dh))
        q, k = apply_rope_halved(torch.cat([q, k], dim=2), cos, sin).split([H, KV], dim=2)
        q, k = q.transpose(1, 2), k.transpose(1, 2)
        v = self.v_proj(x).view(B, T, KV, Dh).transpose(1, 2)
        kh, vh = _repeat_heads(k, H // KV), _repeat_heads(v, H // KV)
        if cache is not None:
            cache[0].index_copy_(2, positions, kh.to(cache[0].dtype))
            cache[1].index_copy_(2, positions, vh.to(cache[1].dtype))
            kh, vh = cache
        S = kh.shape[2]
        scores = torch.baddbmm(bias, q.reshape(B * H, T, Dh),
                               kh.reshape(B * H, S, Dh).transpose(1, 2), alpha=1.0 / math.sqrt(Dh))
        probs = torch.softmax(scores.float(), dim=-1).to(vh.dtype)
        ctx = torch.bmm(probs, vh.reshape(B * H, S, Dh)).view(B, H, T, Dh)
        ctx = ctx.transpose(1, 2).reshape(B, T, H * Dh)
        return self.o_proj(ctx), (cache if cache is not None else (k, v))


class Qwen3MLP(nn.Module):
    def __init__(self, c: QwenEmoConfig):
        super().__init__()
        self.gate_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False)
        self.up_proj = nn.Linear(c.hidden_size, c.intermediate_size, bias=False)
        self.down_proj = nn.Linear(c.intermediate_size, c.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen3Block(nn.Module):
    def __init__(self, c: QwenEmoConfig):
        super().__init__()
        self.input_layernorm = QwenRMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = Qwen3Attention(c)
        self.post_attention_layernorm = QwenRMSNorm(c.hidden_size, c.rms_norm_eps)
        self.mlp = Qwen3MLP(c)

    def forward(self, x, positions, cos, sin, bias, cache=None):
        a, new_kv = self.self_attn(self.input_layernorm(x), positions, cos, sin, bias, cache)
        x = x + a
        return x + self.mlp(self.post_attention_layernorm(x)), new_kv


class Qwen3Model(nn.Module):
    """The checkpoint's `model.` part: embedding, blocks, final norm."""

    def __init__(self, c: QwenEmoConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size)
        self.layers = nn.ModuleList(Qwen3Block(c) for _ in range(c.num_hidden_layers))
        self.norm = QwenRMSNorm(c.hidden_size, c.rms_norm_eps)


def hf_keys(state_dict) -> dict:
    """A Qwen3ForCausalLM state dict in the port's keys: the `model.` prefix
    added where it is missing, the tied `lm_head.weight` dropped."""
    pre = "" if any(k.startswith("model.") for k in state_dict) else "model."
    return {pre + k: v for k, v in state_dict.items() if k != "lm_head.weight"}


class Qwen3LM(nn.Module):
    def __init__(self, cfg: QwenEmoConfig):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen3Model(cfg)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Takes the checkpoint's keys with or without `model.` (`hf_keys`)."""
        return super().load_state_dict(hf_keys(state_dict), strict=strict, assign=assign)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                kv_valid_len: Optional[torch.Tensor] = None):
        """Logits (B, T, vocab) in float32 for input_ids (B, T) at positions
        (T,). Without `kv_caches`: causal attention over the T tokens; also
        returns their K and V, each (layers, B, KV, T, Dh). With them (K, V
        each (layers, B, H, cap, Dh), a KV head once for each of its query
        heads): the tokens' K and V are written at slots `positions`, each
        attends to the slots below kv_valid_len (B,), and the caches are
        returned."""
        c, m = self.cfg, self.model
        (B, T), H = input_ids.shape, c.num_attention_heads
        x = m.embed_tokens(input_ids)
        cos, sin = rope_tables(positions, c.head_dim, c.rope_theta)
        # the attention bias, (B * H or 1, T or 1, S)
        if kv_caches is None:
            keep = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None]
        else:
            cap = kv_caches[0].shape[3]
            keep = torch.arange(cap, device=x.device)[None, :] < kv_valid_len[:, None]
            keep = keep[:, None].expand(B, H, cap).reshape(B * H, 1, cap)
        bias = torch.where(keep, 0.0, NEG_INF)
        ks, vs = [], []
        for i, block in enumerate(m.layers):
            cache = None if kv_caches is None else (kv_caches[0][i], kv_caches[1][i])
            x, (k, v) = block(x, positions, cos, sin, bias, cache)
            ks.append(k)
            vs.append(v)
        x = m.norm(x)
        logits = F.linear(x.float(), m.embed_tokens.weight.float())
        return logits, (kv_caches if kv_caches is not None
                        else (torch.stack(ks), torch.stack(vs)))


class _State:
    """One cache capacity's static buffers and its captured step. The KV
    cache holds each KV head once for each of its query heads (the
    attention's layout)."""

    def __init__(self, c: QwenEmoConfig, cap: int, device: torch.device):
        shape = (c.num_hidden_layers, 1, c.num_attention_heads, cap, c.head_dim)
        self.cap = cap
        self.ks = torch.zeros(shape, device=device)
        self.vs = torch.zeros(shape, device=device)
        self.tok = torch.zeros((), dtype=torch.int64, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.valid = torch.zeros((), dtype=torch.int64, device=device)
        self.logits = torch.zeros(c.vocab_size, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None


class QwenDecoder:
    """Greedy decoding for one Qwen3LM. Holds a state per cache capacity
    (the least recently used of MAX_CAPS goes, with its graph), the stream
    the card's steps run and are captured on, and a lock that makes one
    request at a time own them."""

    def __init__(self, model: Qwen3LM):
        self.model = model
        self.device = model.model.embed_tokens.weight.device
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._states: "OrderedDict[int, _State]" = OrderedDict()
        self._lock = threading.Lock()

    def _state(self, cap: int) -> _State:
        st = self._states.get(cap)
        if st is None:
            if len(self._states) >= MAX_CAPS:
                self._states.popitem(last=False)
            st = self._states[cap] = _State(self.model.cfg, cap, self.device)
        self._states.move_to_end(cap)
        return st

    def prefill(self, st: _State, prompt_ids: Sequence[int]) -> None:
        """The prompt's KV into slots [0, S) and its next token into `tok`;
        position S, valid length S + 1."""
        S = len(prompt_ids)
        ids = torch.as_tensor(np.asarray(prompt_ids, np.int64), device=self.device)[None]
        logits, (ks, vs) = self.model(ids, torch.arange(S, device=self.device))
        rep = st.ks.shape[2] // ks.shape[2]
        st.ks[:, :, :, :S].copy_(_repeat_heads(ks, rep))
        st.vs[:, :, :, :S].copy_(_repeat_heads(vs, rep))
        st.logits.copy_(logits[0, -1])
        st.tok.copy_(torch.argmax(st.logits))
        st.pos.fill_(S)
        st.valid.fill_(S + 1)

    def step(self, st: _State) -> None:
        """One token: `tok` at slot `pos`, attending to `valid` slots; its
        logits and argmax, then position and valid length advanced. All on
        the device: the unit a CUDA graph captures."""
        logits, _ = self.model(st.tok.view(1, 1), st.pos.view(1), (st.ks, st.vs),
                               st.valid.view(1))
        st.logits.copy_(logits[0, -1])
        st.tok.copy_(torch.argmax(st.logits))
        st.pos.add_(1)
        st.valid.add_(1)

    def advance(self, st: _State, eager: bool = False) -> None:
        """`step` once: on the card, unless `eager`, a replay of the state's
        graph; the state's first step runs eagerly and is then captured
        (`cuda_lib.capture`, into the decoder's pool)."""
        if eager or self._stream is None:
            self.step(st)
        elif st.graph is not None:
            st.graph.replay()
        else:
            self.step(st)
            graph = torch.cuda.CUDAGraph()
            with cuda_lib.capture(graph, self._stream, self._pool):
                self.step(st)
            st.graph = graph

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int, eos_token_id: int,
                 eager: bool = False) -> np.ndarray:
        """Greedy tokens after `prompt_ids`, at most max_new_tokens, ending
        with eos when it comes (the JAX `greedy_generate`). On the card the
        steps replay a captured step; `eager` runs them eagerly on the same
        stream and buffers, the yardstick the replays are held to."""
        out = []
        with self._lock:
            caller = None if self._stream is None else torch.cuda.current_stream(self.device)
            if caller is not None:
                self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                st = self._state(cache_cap(len(prompt_ids), max_new_tokens))
                self.prefill(st, prompt_ids)
                for i in range(max_new_tokens):
                    out.append(int(st.tok))
                    if out[-1] == eos_token_id or i == max_new_tokens - 1:
                        break
                    self.advance(st, eager)
            if caller is not None:
                caller.wait_stream(self._stream)
        return np.asarray(out, np.int64)


def greedy_generate(model: Qwen3LM, prompt_ids: Sequence[int], max_new_tokens: int,
                    eos_token_id: int, eager: bool = False) -> np.ndarray:
    """One greedy decode with a decoder of its own (the JAX function's
    counterpart); a caller that decodes again keeps a `QwenDecoder`."""
    return QwenDecoder(model).generate(prompt_ids, max_new_tokens, eos_token_id, eager)

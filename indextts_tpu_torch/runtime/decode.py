"""Autoregressive decode loop for UnifiedVoice and UnifiedVoiceV1 (sampling
and greedy routes).

Counterpart of indextts_tpu/runtime/decode.py `GPTDecoder.generate`: prefill
[conds][right-aligned text][start_mel] once, then one token per step against
a KV cache in its natural layout (L, B, H, cap, Dh), attention over keys <
valid_len outside the prompt's left-pad hole. The cache is float (kernel K1)
or, with `kv_int8` (the JAX package's `kv_quant` or `attn_impl="pallas_q8"`),
int8 with per-(layer, row, head, token) f32 scales (kernel K4): the prefill
KV is quantized once with `quantize_kv`, and each step quantizes and writes
its own token's K/V and scales in place. Processor order as the JAX
loop's: repetition penalty (the fake-prompt tokens {1, start_mel} included,
model_v2.py:785-794) -> typical filter -> stop ban, each as the decoder's
`SamplingConfig` says, then temperature -> top-k -> top-p -> draw; greedy
takes the argmax of the processed logits. Codes are stop-padded; lengths
count the stop token.

The JAX package runs the loop as one jitted `lax.while_loop`. Here the loop
state lives in static buffers (`DecodeState`: caches, logits, codes, the
finished flags, the penalty set, the step counter, the prompt hole and the
sampling scalars), and the step (`GPTDecoder._advance`: embed the last
token, the GPT step, the logits, pick the next token) reads and writes only
those, every per-token value a device tensor. On the card the step is
captured once per (B, cap) as a CUDA graph, and `generate` replays it once a
token; only the prefill, the first pick and the finish check, on the host
every FINISH_CHECK_EVERY tokens, run eagerly. The CPU runs the same step
eagerly. A capture or replay that fails raises.

Continuous batching (JAX `prefill_request`, `insert_slot`, `step_chunk`)
runs on a `SlotState`: n_slots rows, each its own request's decode at its
own cache position, code count and prompt hole. A request is prefilled
alone into a free row (`prefill_request`); `step_chunk` advances every row
by `chunk` steps (`slot_step`, captured and replayed on the card as above),
and the host reads the rows once a chunk (`read_slots`).
runtime/batcher.py schedules the requests.

Conditioning-prefix KV reuse (JAX `cond_prefill`, `_prefill_with_cond`):
`cond_prefill` returns the float KV of the conditioning positions (34 for
UnifiedVoice, 32 for UnifiedVoiceV1: every width here is the conds' own
shape), which depend on nothing else; `generate(cond_kv=...)` then
prefills only the prompt's tail [text][start_mel] on top of it, as one
chunk through the GPT
(`UnifiedVoice.gpt_prefill_with_past`, plain torch ops as XLA ran it). The
prefix stays float under `kv_int8`: the whole prompt's KV is quantized after
the tail, the values the monolithic prefill quantizes. The captured step
and its state are the same on both routes. `supports_cond_kv` follows the
JAX rule on the resolved attention layout.

Beam search (JAX `generate_beam`, HF _beam_search in both variants) runs
on a `BeamState`: the one prompt prefilled once and copied into nb rows,
one a beam; `_beam_step` (candidates, the pool of finished hypotheses, the
reorder of every cache component by the surviving beams, one GPT step over
the nb rows) is captured once per (nb, cap) and replayed as the sampling
step is; HF's is_done is computed on the card and freezes the state, so
the host's finish check ends the loop at the JAX loop's step.

A request's segments decoded at once (the engine's batched route) are one
`generate` over B rows: the texts right-aligned in one prompt, each row its
own pad hole, every row's next key at the same slot, the loop ending once
every row has finished.

A bfloat16 GPT (the engine's `gpt_dtype`) decodes in bfloat16 as the JAX
decoder with `param_dtype` bfloat16: the prompt and step embeddings, the
blocks and a float cache in bfloat16 (K1 reads it with a float32 query and
returns float32), an int8 cache quantized from the bfloat16 K/V in float32;
the logits float32 (the final norm and the head on the float32 hidden
state), and sampling on them in float32.

Text-prefix KV reuse (JAX `text_prefix_prefill`, the `prefix_extra` slice
of `_generate` and `generate_beam`): with the prompt's text LEFT-aligned
(`build_text_prompt_arrays(align="left")`), [conds][start_text][text[:m]]
sits at the same slots in every request whose text starts with those m
tokens, so its float KV (`text_prefix_prefill`) serves as `cond_kv`, and
the prefill runs only the rest of the tail: [text[m:]][stop][pads]
[start_mel]. The pads then sit between [stop] and [start_mel], and that
hole reaches K1 and K4 through the state's hole fields as the right-
aligned prompt's does.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt2 import prompt_hole, quantize_kv
from indextts_tpu_torch.models.unified_voice import UnifiedVoice
from indextts_tpu_torch.ops import cuda_lib, decode_attention, gemv

NEG_INF = -1e9
# decode steps between host checks for "every row finished"
FINISH_CHECK_EVERY = 16
# a cache's capacity is S + max_new rounded up to this: K1/K4's launch plan
# depends on the capacity, so requests of nearby lengths share a capture
CAP_ROUND = 256
# decode shapes (B, cap) whose buffers and captured steps are kept
MAX_STATES = 8


@dataclass(frozen=True)
class SamplingConfig:
    """The JAX package's SamplingConfig (indextts_tpu/runtime/decode.py:35-50),
    its fields and defaults in its order. A decoder's captured steps belong
    to its one SamplingConfig, as a change recompiles the JAX loop."""

    do_sample: bool = True
    top_k: int = 30
    use_repetition_penalty: bool = True
    # the HF fake-prompt tokens {1, start_mel} in the penalty set, as the
    # reference's generate() over fake_inputs (model_v2.py:785-794)
    hf_fake_prompt_penalty: bool = True
    # never emit the stop token: every row decodes exactly max_new codes
    # (deterministic work on any weights, as the JAX benchmarks decode)
    ban_stop_token: bool = False
    # typical sampling (model_v2.py:858-866), after the repetition penalty
    use_typical_sampling: bool = False
    typical_mass: float = 0.9


@dataclass
class GenerateResult:
    codes: torch.Tensor  # (B, max_new) int64, stop-token padded
    lengths: torch.Tensor  # (B,) — generated length INCLUDING the stop token


def repetition_penalty(logits, penal_mask, penalty):
    """HF RepetitionPenaltyLogitsProcessor: score<0 ? score*p : score/p."""
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(penal_mask, penalized, logits)


def typical_filter(scores, mass: float, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF TypicalLogitsWarper as the JAX package's `typical_filter`
    (indextts_tpu/runtime/decode.py:92-115), step for step: keep the tokens
    whose -log p lies closest to the entropy until `mass` of probability is
    reached; the others get NEG_INF. The sort is stable, as jnp.argsort is,
    so equal scores keep the lower index first. No host read and no shape
    that depends on the data, so a captured step may run it."""
    normalized = torch.log_softmax(scores, dim=-1)
    p = torch.exp(normalized)
    ent = -torch.sum(torch.where(p > 0, normalized * p, torch.zeros_like(p)), dim=-1,
                     keepdim=True)
    shifted = torch.abs(-normalized - ent)
    order = torch.argsort(shifted, dim=-1, stable=True)  # ascending
    sorted_shifted = torch.gather(shifted, -1, order)
    sorted_logits = torch.gather(scores, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # every cum < mass (mass >= 1) leaves JAX's index past the end, which its
    # gather fills with NaN and removes nothing; the last index removes
    # nothing too
    last_ind = torch.sum(cum < mass, dim=-1, keepdim=True).clamp(max=scores.shape[-1] - 1)
    cutoff = torch.gather(sorted_shifted, -1, last_ind)
    remove_sorted = sorted_shifted > cutoff
    if min_tokens_to_keep > 1:
        remove_sorted[..., :min_tokens_to_keep] = False
    remove = torch.empty_like(remove_sorted).scatter_(-1, order, remove_sorted)
    return torch.where(remove, torch.full_like(scores, NEG_INF), scores)


def warp_top_k_top_p(logits, temperature, top_p, top_k: int, min_tokens_to_keep: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """temperature -> top-k -> top-p on the descending top-k subset, the
    first `min_tokens_to_keep` always kept (HF's warpers take 2 under beam
    search). Returns (vals, idx) (B, k): kept logits, NEG_INF where top-p
    drops a token. temperature and top_p are floats or 0-d tensors."""
    logits = logits / temperature
    vals, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[:, :min_tokens_to_keep] = True
    return torch.where(keep, vals, torch.full_like(vals, NEG_INF)), idx


def sample_top_k_top_p(logits, generator: torch.Generator, temperature, top_p,
                       top_k: int):
    """One draw per row from the warped distribution, as an exponential
    race: argmax(p / q) with q ~ Exp(1) picks token i with probability p_i.
    torch.multinomial takes the same path for one sample, but first checks
    its input on the host, which a captured step cannot."""
    vals, idx = warp_top_k_top_p(logits, temperature, top_p, top_k)
    p = torch.softmax(vals, dim=-1)
    q = torch.empty_like(p).exponential_(generator=generator)
    choice = torch.argmax(p / q, dim=-1, keepdim=True)
    return torch.gather(idx, 1, choice)[:, 0]


def top_first(x, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of x's last dimension, descending, the lower index
    first among equal values, as jax.lax.top_k orders them (torch.topk
    promises no order among ties): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def draw_candidates(scores, generator: torch.Generator, k: int) -> torch.Tensor:
    """k draws without replacement from softmax(scores) over the last
    dimension, in draw order: the top k of scores - log(q), q ~ Exp(1)
    from `generator`. -log(q) is Gumbel(0, 1), so this is the Gumbel-top-k
    the JAX beam search draws with (indextts_tpu/runtime/decode.py:
    687-695), without a host check of its input (torch.multinomial's)."""
    q = torch.empty_like(scores).exponential_(generator=generator)
    return top_first(scores - torch.log(q), k)[1]


def _step_counters():
    """The launch counters of the kernels a decode step may run (K1, K4-K8)."""
    return (decode_attention.counter, decode_attention.q8_counter, gemv.gemv_counter,
            gemv.mlp_counter, gemv.gemv4_counter, gemv.mlp4_counter)


class _LoopState:
    """The static buffers a decode loop reads and writes, shared by every
    request that decodes in them: the caches of `batch` rows of `cap`
    slots, the logits, the codes, the finished flags, the penalty set, each
    row's prompt hole, the sampling scalars and the generator the draws come
    from; and the step captured over them for each value of do_sample
    (`graphs`: the CUDA graph and each step counter's launches in it). A
    float cache holds the model's compute dtype (`dtype`, that of its
    projections, as the JAX decoder's cache takes theirs); the logits are
    float32 either way. The caches hold `heads` heads (the model's: a
    tensor-parallel model's local heads)."""

    def __init__(self, cfg: GPTConfig, heads: int, batch: int, cap: int, kv_int8: bool,
                 device, generator: torch.Generator, dtype: torch.dtype = torch.float32):
        L, H, V = cfg.layers, heads, cfg.number_mel_codes
        kv = (L, batch, H, cap, cfg.head_dim)
        if kv_int8:
            self.caches = tuple(torch.zeros(kv, dtype=torch.int8, device=device)
                                for _ in range(2)) + tuple(
                torch.zeros(kv[:4], device=device) for _ in range(2))
        else:
            self.caches = tuple(torch.zeros(kv, dtype=dtype, device=device) for _ in range(2))
        self.cap = cap
        self.generator = generator
        zeros = functools.partial(torch.zeros, device=device)
        self.logits = zeros((batch, V))
        self.codes = zeros((batch, cap), dtype=torch.long)  # a request uses max_new
        self.finished = zeros(batch, dtype=torch.bool)
        self.penal_mask = zeros((batch, V), dtype=torch.bool)
        self.hole_s = zeros(batch, dtype=torch.int32)
        self.hole_e = zeros(batch, dtype=torch.int32)
        self.temperature, self.top_p, self.penalty = zeros(()), zeros(()), zeros(())
        self.graphs: Dict[bool, Tuple[torch.cuda.CUDAGraph, list]] = {}

    def tensors(self):
        """Every buffer: the caches, then the other tensors by name."""
        return list(self.caches) + [t for t in vars(self).values()
                                    if isinstance(t, torch.Tensor)]


class DecodeState(_LoopState):
    """One request's decode of B rows in step: every row's last code sits
    at the same index `step` and its next key at slot S + step."""

    def __init__(self, cfg: GPTConfig, heads: int, batch: int, cap: int, kv_int8: bool,
                 device, generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, heads, batch, cap, kv_int8, device, generator, dtype)
        zeros = functools.partial(torch.zeros, device=device, dtype=torch.long)
        self.tok = zeros(batch)  # the last code picked
        self.step = zeros(1)  # index of the last code picked
        self.start = zeros(1)  # S, the prompt's length


class BeamState(DecodeState):
    """One request's beam search over `nb` rows, one a beam, as the JAX
    loop's state (indextts_tpu/runtime/decode.py:645-662): the rows'
    caches, logits, codes, penalty sets, last codes, `step` and S as in
    DecodeState (every beam of one prompt, so one hole); each beam's
    score; the pool of finalized hypotheses (HF BeamHypotheses, nb
    entries: normalized scores, codes, lengths); `finished`, HF's is_done
    on every row; and the length penalty."""

    def __init__(self, cfg: GPTConfig, heads: int, nb: int, cap: int, kv_int8: bool,
                 device, generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, heads, nb, cap, kv_int8, device, generator, dtype)
        zeros = functools.partial(torch.zeros, device=device)
        self.beam_scores = zeros(nb)
        self.fin_scores = zeros(nb)
        self.fin_codes = zeros((nb, cap), dtype=torch.long)
        self.fin_lens = zeros(nb, dtype=torch.long)
        self.length_penalty = zeros(())


class SlotState(_LoopState):
    """`n_slots` rows, each one request's decode or idle, as JAX
    ContinuousBatcher's state (indextts_tpu/runtime/batcher.py:82-105): a
    row's own cache position `pos` (its next key's slot), code count
    `gen_count`, `active` flag (a request holds the row) and prompt hole.
    A row is idle when it is finished or inactive; an idle row starts
    finished. `max_new` codes a request at most, so `cap` must hold a
    prompt of S and S + max_new keys; the last slot of an idle row's cache
    and its last code column take the writes of its idle steps."""

    def __init__(self, cfg: GPTConfig, heads: int, n_slots: int, cap: int, max_new: int,
                 kv_int8: bool, device, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, heads, n_slots, cap, kv_int8, device, generator, dtype)
        self.max_new = max_new
        zeros = functools.partial(torch.zeros, n_slots, device=device)
        self.pos = zeros(dtype=torch.long)
        self.gen_count = zeros(dtype=torch.long)
        self.active = zeros(dtype=torch.bool)
        self.finished.fill_(True)

    def row(self, b: int) -> "SlotState":
        """A copy of slot b as a one-slot state, without its captured
        steps: what a single-row step is held to a batched one with."""
        one = copy.copy(self)
        one.graphs = {}
        one.caches = tuple(c[:, b:b + 1].clone() for c in self.caches)
        for name, t in vars(self).items():
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                setattr(one, name, t[b:b + 1].clone())
        return one


def cache_cap(prompt_len: int, max_new: int) -> int:
    """Cache slots for a prompt of `prompt_len` and `max_new` new tokens."""
    return -(-(prompt_len + max_new) // CAP_ROUND) * CAP_ROUND


class GPTDecoder:
    """Decodes for one UnifiedVoice. Holds the decode states, the stream
    the card's steps run and are captured on, and the sampling generator,
    which each request reseeds from its own seed (one seed, one code row).
    States are keyed on (B, cap): the route (float, W8 or W4 blocks, a
    float or int8 cache) is the decoder's own, one decoder per model. A
    lock makes one request at a time own them: prefill, steps and
    readout.

    A model that parallel/tp.py `tensor_parallel` cut over a mesh's model
    axis (`model.mesh`) decodes with its local heads in the caches, every
    rank of a model group picking the same code from the gathered logits;
    its steps run eagerly, their collectives outside any capture."""

    def __init__(self, model: UnifiedVoice, cfg: GPTConfig,
                 sampling: SamplingConfig = SamplingConfig(), kv_int8: bool = False,
                 attn_impl: str = "auto"):
        self.model = model
        self.cfg = cfg
        self.sampling = sampling
        self.kv_int8 = kv_int8
        # the JAX beam search keeps an int8 cache under kv_quant only: a
        # pallas_q8 model serves it a float cache (indextts_tpu/models/
        # gpt2.py:831-833)
        self.beam_kv_int8 = kv_int8 and attn_impl != "pallas_q8"
        self.attn_impl = attn_impl
        self.device = model.mel_embedding.weight.device
        self.mesh = getattr(model, "mesh", None)
        self.heads = model.gpt.h[0].attn.n_head
        self.generator = torch.Generator(device=self.device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._states: "OrderedDict[tuple, DecodeState]" = OrderedDict()
        self._lock = threading.Lock()
        # cumulative decode counters (tokens emitted, wall seconds in generate)
        self.tokens = 0
        self.seconds = 0.0

    @property
    def supports_cond_kv(self) -> bool:
        """Does `generate(cond_kv=...)` serve this decoder's route? The JAX
        rule (indextts_tpu/runtime/decode.py:166-176) on the configured
        attn_impl, "auto" resolving to "xla": the int8 cache reuses under
        "xla" only, the float cache under "xla" and "xla_bucketed"; the
        Pallas layouts ("pallas_ragged", "pallas_q8") prefill whole, so one
        config takes the same route in both packages."""
        impl = "xla" if self.attn_impl == "auto" else self.attn_impl
        if self.kv_int8:
            return impl == "xla"
        return impl in ("xla", "xla_bucketed")

    @torch.inference_mode()
    def cond_prefill(self, conds_latent) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float KV (pk, pv) of the conditioning prefix alone, each (L,
        B, H, P, Dh), on the current stream: the causal prefix of every
        prompt, a function of `conds_latent` (B, P, D) only (JAX
        `cond_prefill`, indextts_tpu/runtime/decode.py:1060-1089). Float
        under `kv_int8` too."""
        mask = torch.ones(conds_latent.shape[:2], dtype=torch.bool,
                          device=conds_latent.device)
        _, kv = self.model.gpt_prefill(conds_latent, mask)
        return kv

    @torch.inference_mode()
    def text_prefix_prefill(self, conds_latent, prefix_ids) -> Tuple[torch.Tensor, torch.Tensor]:
        """The float KV (pk, pv) of [conds][start_text][prefix_ids], each (L,
        1, H, P+1+m, Dh) for m prefix ids, on the current stream (JAX
        `text_prefix_prefill`, indextts_tpu/runtime/decode.py:207-243): the
        causal prefix of every LEFT-aligned prompt whose text starts with
        `prefix_ids`, for `generate(cond_kv=...)`. Float under `kv_int8`
        too, as `cond_prefill`'s."""
        m = len(prefix_ids)
        dev = conds_latent.device
        ids = torch.as_tensor(np.concatenate([[self.cfg.start_text_token], prefix_ids]),
                              dtype=torch.long, device=dev)[None]
        pos = torch.arange(m + 1, device=dev)[None]
        valid = torch.ones((1, m + 1), dtype=torch.bool, device=dev)
        prompt = torch.cat([conds_latent, self.model.embed_text_prompt(ids, pos, valid)], dim=1)
        _, kv = self.model.gpt_prefill(prompt, torch.ones(prompt.shape[:2], dtype=torch.bool,
                                                          device=dev))
        return kv

    def build_text_prompt_arrays(self, text_ids: np.ndarray, text_lens: np.ndarray,
                                 bucket: int, align: str = "right"
                                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Place [start][text][stop] in a (B, bucket+2) buffer: right-aligned,
        the pads first (prepare_gpt_inputs left-padding, model_v2.py:749-779),
        or with align="left" the sequence first and the pads after it, so
        that a shared text prefix takes the same slots in every request
        (text-prefix reuse; JAX `build_text_prompt_arrays`)."""
        if align not in ("left", "right"):
            raise ValueError(f"align={align!r}: 'left' or 'right'")
        B = text_ids.shape[0]
        L = bucket + 2
        ids = np.zeros((B, L), dtype=np.int64)
        pos = np.zeros((B, L), dtype=np.int64)
        valid = np.zeros((B, L), dtype=bool)
        for b in range(B):
            n = int(text_lens[b])
            seq = [self.cfg.start_text_token] + list(text_ids[b, :n]) + [
                self.cfg.stop_text_token]
            off = 0 if align == "left" else L - len(seq)
            ids[b, off:off + len(seq)] = seq
            pos[b, off:off + len(seq)] = np.arange(len(seq))
            valid[b, off:off + len(seq)] = True
        return ids, pos, valid

    def _state(self, batch: int, cap: int, beam: bool = False) -> DecodeState:
        """The state of `batch` rows and `cap` slots, made on first use: a
        DecodeState keyed (batch, cap), or with `beam` a BeamState keyed
        ("beam", batch, cap), so that a beam search never takes a sampling
        state of as many rows. The least recently used of MAX_STATES goes,
        with its captured steps."""
        key = ("beam", batch, cap) if beam else (batch, cap)
        st = self._states.get(key)
        if st is None:
            if len(self._states) >= MAX_STATES:
                self._states.popitem(last=False)
            st = self._states[key] = (BeamState if beam else DecodeState)(
                self.cfg, self.heads, batch, cap, self.beam_kv_int8 if beam else self.kv_int8,
                self.device, self.generator, self.model.gpt.dtype)
        self._states.move_to_end(key)
        return st

    def on_stream(self):
        """The context that makes the decoder's stream current (a no-op on
        the CPU)."""
        return torch.cuda.stream(self._stream)

    @contextlib.contextmanager
    def _on_request(self, seed: Optional[int]):
        """A request's decode, under the decoder's lock: its generator
        seeded with `seed` (None: a fresh random seed), its stream made
        current after the caller's work; on exit the caller's stream waits
        for it."""
        if seed is None:
            self.generator.seed()
        else:
            self.generator.manual_seed(seed)
        caller = None if self._stream is None else torch.cuda.current_stream(self.device)
        if caller is not None:
            self._stream.wait_stream(caller)
        with self.on_stream():
            yield
        if caller is not None:
            caller.wait_stream(self._stream)

    def _prompt_prefill(self, conds_latent, text_ids, text_pos, text_valid, cond_kv=None,
                        kv_int8: Optional[bool] = None):
        """The prompt [conds][text][start_mel] through the GPT: its last
        logits, its KV as the cache holds it (quantized with `kv_int8`, by
        default the decoder's) and its (B, S) mask. With `cond_kv`
        (`cond_prefill` of these conds, or `text_prefix_prefill` of them
        and the first m text ids of a left-aligned prompt) only the rest of
        the tail runs, on top of the prefix: the tail's first
        `cond_kv[0].shape[3] - P` positions are the prefix's."""
        model = self.model
        B = conds_latent.shape[0]
        dev = conds_latent.device
        text_emb = model.embed_text_prompt(text_ids, text_pos, text_valid)
        start_emb = model.embed_mel_start(B, dev)
        tail = torch.cat([text_emb, start_emb], dim=1)
        ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
        tail_mask = torch.cat([text_valid, ones], dim=1)
        prompt_mask = torch.cat([ones.expand(B, conds_latent.shape[1]), tail_mask], dim=1)
        if cond_kv is None:
            hidden, (pk, pv) = model.gpt_prefill(torch.cat([conds_latent, tail], dim=1),
                                                 prompt_mask)
        else:
            extra = cond_kv[0].shape[3] - conds_latent.shape[1]
            hidden, (pk, pv) = model.gpt_prefill_with_past(tail[:, extra:],
                                                           tail_mask[:, extra:], cond_kv)
        if self.kv_int8 if kv_int8 is None else kv_int8:
            (k8, ksc), (v8, vsc) = quantize_kv(pk), quantize_kv(pv)
            prompt_kv = (k8, v8, ksc, vsc)
        else:
            prompt_kv = (pk, pv)
        return model.mel_logits_from_hidden(hidden[:, -1]), prompt_kv, prompt_mask

    def prefill(self, conds_latent, text_ids, text_pos, text_valid, max_new: int,
                cond_kv=None, num_beams: int = 0) -> DecodeState:
        """Prompt prefill into the static caches of the state of shape (B,
        cache_cap(S, max_new)): the prompt's KV at slots [0, S), quantized
        once with `kv_int8`, its last logits, S and the prompt's hole. The
        slots past S keep an earlier request's values, which no step reads:
        every key a step attends to was written by this request. With
        `cond_kv` the prefix's KV is taken from it and only the rest of the
        tail is prefilled (`_prompt_prefill`); S and the hole are the same.
        With `num_beams` the one prompt (B=1) is prefilled once, and its KV
        and logits copied into every row of a BeamState of num_beams rows."""
        logits, prompt_kv, prompt_mask = self._prompt_prefill(
            conds_latent, text_ids, text_pos, text_valid, cond_kv,
            self.beam_kv_int8 if num_beams else self.kv_int8)
        B, S = prompt_mask.shape
        if num_beams:
            B = num_beams
        st = self._state(B, cache_cap(S, max_new), beam=bool(num_beams))
        for c, t in zip(st.caches, prompt_kv):
            c[:, :, :, :S].copy_(t)
        st.logits.copy_(logits)
        st.start.fill_(S)
        hole_s, hole_e = prompt_hole(prompt_mask)
        st.hole_s.copy_(hole_s)
        st.hole_e.copy_(hole_e)
        return st

    def _fake_prompt_penalty(self, penal_mask: torch.Tensor):
        """A fresh penalty set, (rows, V) or one row (V,): empty, or the HF
        fake-prompt tokens {1, start_mel} where the sampling config penalizes
        them (JAX decode.py:443-445, batcher.py:178-179)."""
        penal_mask.zero_()
        s = self.sampling
        if s.use_repetition_penalty and s.hf_fake_prompt_penalty:
            penal_mask[..., 1] = True
            penal_mask[..., self.cfg.start_mel_token] = True

    def _reset(self, st: DecodeState, temperature: float, top_p: float, penalty: float):
        """A request's loop state before its first pick: no codes (all stop),
        nothing finished, the fake-prompt penalty set, step 0, and its
        sampling scalars."""
        st.codes.fill_(self.cfg.stop_mel_token)
        st.finished.zero_()
        self._fake_prompt_penalty(st.penal_mask)
        st.step.zero_()
        st.temperature.fill_(temperature)
        st.top_p.fill_(top_p)
        st.penalty.fill_(penalty)

    def _processed(self, st: _LoopState) -> torch.Tensor:
        """The logits as the JAX loop hands them to its warpers or argmax
        (indextts_tpu/runtime/decode.py:457-467): the repetition penalty with
        use_repetition_penalty, then the typical filter with
        use_typical_sampling, then the stop token banned with
        ban_stop_token."""
        s = self.sampling
        lg = st.logits
        if s.use_repetition_penalty:
            lg = repetition_penalty(lg, st.penal_mask, st.penalty)
        if s.use_typical_sampling:
            lg = typical_filter(lg, s.typical_mass)
        if s.ban_stop_token:
            lg = lg.clone()  # never the state's logits
            lg[:, self.cfg.stop_mel_token] = NEG_INF
        return lg

    def _choose(self, st: _LoopState, do_sample: bool) -> torch.Tensor:
        """Each row's next code from its processed logits (`_processed`): a
        draw from the state's generator, or the argmax."""
        lg = self._processed(st)
        if do_sample:
            return sample_top_k_top_p(lg, st.generator, st.temperature, st.top_p,
                                      self.sampling.top_k)
        return torch.argmax(lg, dim=-1)

    def _pick(self, st: DecodeState, do_sample: bool):
        """Pick code `step` from the logits: stop for a finished row; write
        it to codes, the finished flags and the penalty set."""
        stop = self.cfg.stop_mel_token
        tok = torch.where(st.finished, stop, self._choose(st, do_sample))
        st.tok.copy_(tok)
        st.codes.index_copy_(1, st.step, tok[:, None])
        st.finished.logical_or_(tok == stop)
        st.penal_mask.scatter_(1, tok[:, None], True)

    def _forward(self, st: DecodeState):
        """The last code's embedding at mel position step + 2 through the
        GPT, its K/V written at slot S + step, keys < S + step + 1
        attending: the next logits; then step + 1."""
        model = self.model
        B = st.tok.shape[0]
        index = st.start + st.step
        valid = (index + 1).to(torch.int32).repeat(B)
        emb = model.embed_mel_step(st.tok, st.step.expand(B))
        hidden = model.gpt_decode_step(emb, st.caches, index.expand(B), valid,
                                       st.hole_s, st.hole_e)
        st.logits.copy_(model.mel_logits_from_hidden(hidden[:, 0]))
        st.step.add_(1)

    def _advance(self, st: DecodeState, do_sample: bool):
        """One decode step over the state, the unit a CUDA graph captures:
        `_forward`, then the pick of the next code."""
        self._forward(st)
        self._pick(st, do_sample)

    def _capture(self, st: _LoopState, step, do_sample: bool):
        """Capture one `step` over `st` on the decoder's stream, which has
        run one eagerly just before (K6/K8 set up their per-stream
        counters, cuBLAS its workspace), with the state's generator
        registered. The capture launches nothing: the step counters keep
        the calls made under it apart (`LaunchCounter.take_captured`), to
        add once a replay. `cuda_lib.capture`: other serving threads' CUDA
        calls go on during the capture, other captures wait for it."""
        graph = torch.cuda.CUDAGraph()
        if do_sample:
            graph.register_generator_state(st.generator)
        counters = _step_counters()
        for c in counters:
            c.take_captured()
        with cuda_lib.capture(graph, self._stream):
            step(st, do_sample)
        st.graphs[do_sample] = (graph, [c.take_captured() for c in counters])
        return st.graphs[do_sample]

    def _steps(self, st: _LoopState, step, do_sample: bool, n: int, eager: bool,
               until_finished: bool = False):
        """`step` over `st`, n times. On the card, unless `eager`, the first
        runs eagerly and is captured, the rest replay the capture (a
        state's later calls replay from the start). With `until_finished`,
        stop once every row has finished, checked on the host every
        FINISH_CHECK_EVERY steps."""
        capture = not eager and self._stream is not None
        if capture and self.mesh is not None:
            raise ValueError("a tensor-parallel decoder steps eagerly (its collectives are "
                             "not captured): pass eager=True")
        graph, rise = st.graphs.get(do_sample, (None, None)) if capture else (None, None)
        replays = 0
        for r in range(n):
            if (until_finished and (r + 1) % FINISH_CHECK_EVERY == 0
                    and bool(st.finished.all())):
                break
            if graph is not None:
                graph.replay()
                replays += 1
                continue
            step(st, do_sample)
            if capture:
                graph, rise = self._capture(st, step, do_sample)
        for c, k in zip(_step_counters(), rise or ()):
            c.add_replayed(k * replays)

    def _loop(self, st: DecodeState, do_sample: bool, max_new: int, eager: bool):
        """Codes 0 .. max_new - 1: the first picked from the prefill's
        logits, each next by one step, stopping early once every row has
        finished (checked on the host every FINISH_CHECK_EVERY codes). On
        the card, unless `eager`, a step is a replay of the captured one."""
        self._pick(st, do_sample)
        self._steps(st, self._advance, do_sample, max_new - 1, eager, until_finished=True)

    @torch.inference_mode()
    def generate(self, conds_latent, text_ids, text_pos, text_valid,
                 seed: Optional[int], max_new: int,
                 temperature: float = 0.8, top_p: float = 0.8,
                 repetition_penalty_value: float = 10.0,
                 do_sample: Optional[bool] = None, eager: bool = False,
                 cond_kv=None) -> GenerateResult:
        """Decode up to max_new codes a row. Sampling draws from the
        decoder's generator seeded with `seed` (None: a fresh random seed),
        so one seed gives one code row, captured or eager. On the card the
        steps are replays of a captured step; `eager` runs them eagerly
        instead, on the same stream and state: the yardstick the captured
        loop is held to (same codes from one seed). The CPU always runs
        them eagerly. `cond_kv`: `cond_prefill(conds_latent)` (B or 1
        rows), or `text_prefix_prefill` of them and the text's first ids on
        a left-aligned prompt, whose prefix the prefill then reuses; the
        caller's current stream must be ordered after the work that made
        it."""
        if cond_kv is not None and not self.supports_cond_kv:
            raise ValueError(f"cond_kv on a decoder whose layout prefills whole "
                             f"(attn_impl={self.attn_impl!r}, kv_int8={self.kv_int8})")
        do_sample = self.sampling.do_sample if do_sample is None else do_sample
        with self._lock:
            t0 = time.perf_counter()
            with self._on_request(seed):
                st = self.prefill(conds_latent, text_ids, text_pos, text_valid, max_new,
                                  cond_kv)
                self._reset(st, temperature, top_p, repetition_penalty_value)
                self._loop(st, do_sample, max_new, eager)
            codes = st.codes[:, :max_new].clone()
            is_stop = codes == self.cfg.stop_mel_token
            first = torch.argmax(is_stop.int(), dim=1)
            lengths = torch.where(is_stop.any(dim=1), first + 1,
                                  torch.full_like(first, max_new))
            self.tokens += int(lengths.sum())
            self.seconds += time.perf_counter() - t0
        return GenerateResult(codes=codes, lengths=lengths)

    @torch.inference_mode()
    def forced_logits(self, conds_latent, text_ids, text_pos, text_valid,
                      codes: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: the (B, n, V) float32 logits that each of the n
        `codes` (B, n) of a row is picked from, every step fed the given
        code instead of a pick; the raw logits, before the penalty, the
        filters and the stop ban. The steps run eagerly."""
        n = codes.shape[1]
        with self._lock, self._on_request(None):
            st = self.prefill(conds_latent, text_ids, text_pos, text_valid, n)
            st.step.zero_()
            out = [st.logits.clone()]
            for i in range(n - 1):
                st.tok.copy_(codes[:, i])
                self._forward(st)
                out.append(st.logits.clone())
        return torch.stack(out, dim=1)

    # -- beam search ----------------------------------------------------------
    # The counterpart of the JAX decoder's generate_beam (indextts_tpu/
    # runtime/decode.py:545-866): HF _beam_search over the rows of one
    # BeamState, a step captured and replayed as the sampling loop's.

    def _reset_beam(self, st: BeamState, temperature: float, top_p: float, penalty: float,
                    length_penalty: float):
        """A beam search's state before its first step: `_reset`'s, the
        first beam's score 0 and the others' NEG_INF (so that the first
        step's candidates come from one beam), an empty pool."""
        self._reset(st, temperature, top_p, penalty)
        st.beam_scores.fill_(NEG_INF)
        st.beam_scores[0] = 0.0
        st.fin_scores.fill_(NEG_INF)
        st.fin_codes.fill_(self.cfg.stop_mel_token)
        st.fin_lens.zero_()
        st.length_penalty.fill_(length_penalty)

    def _beam_step(self, st: BeamState, do_sample: bool):
        """One step of beam search, the unit a CUDA graph captures: the body
        of the JAX loop (indextts_tpu/runtime/decode.py:663-757) after its
        condition, HF's is_done (`:761-773`), computed here on the card.
        log_softmax; the repetition penalty and the stop ban as the sampling
        config says (no typical filter, as in JAX); with do_sample the warpers a
        beam (temperature, top-k, top-p, two tokens kept); each beam's
        score added; 2 nb candidates, the top ones or, with do_sample, 2 nb
        draws without replacement sorted by their score; the eos candidates
        ranked below nb into the pool at score / (S + step) ^
        length_penalty; the first nb others the next beams; codes, penalty
        sets and every cache component reordered by their beams; their
        tokens written at `step`; one GPT step over the nb rows at slot S +
        step; the next logits. Once is_done holds, a step leaves `step`,
        the beams' scores, the codes and the pool as they are, so the host's
        check every FINISH_CHECK_EVERY steps stops the loop at the JAX
        loop's step. Ties go to the lower index, as jax.lax.top_k's do."""
        model, cfg = self.model, self.cfg
        nb, V = st.tok.shape[0], cfg.number_mel_codes
        step = st.step
        norm = (st.start + step).float() ** st.length_penalty
        worst = st.fin_scores[nb - 1]
        done = st.finished[0] | ((worst > NEG_INF) & (worst >= st.beam_scores.max() / norm[0]))

        s = self.sampling
        logp = torch.log_softmax(st.logits.float(), dim=-1)
        if s.use_repetition_penalty:
            logp = repetition_penalty(logp, st.penal_mask, st.penalty)
        if s.ban_stop_token:
            logp[:, cfg.stop_mel_token] = NEG_INF
        if do_sample:
            vals, idx = warp_top_k_top_p(logp, st.temperature, st.top_p, self.sampling.top_k,
                                         min_tokens_to_keep=2)
            logp = torch.full_like(logp, NEG_INF).scatter_(1, idx, vals)
        flat = (st.beam_scores[:, None] + logp).reshape(-1)
        if do_sample:
            drawn = draw_candidates(flat, st.generator, 2 * nb)
            cand_scores, order = top_first(flat[drawn], 2 * nb)
            cand = drawn[order]
        else:
            cand_scores, cand = top_first(flat, 2 * nb)
        cand_beam, cand_tok = cand // V, cand % V
        is_eos = cand_tok == cfg.stop_mel_token

        # the pool: eos candidates ranked below nb, each its beam's codes
        # with the eos at `step`, of length step + 1
        rank = torch.arange(2 * nb, device=flat.device)
        fin = torch.where(is_eos & (rank < nb), cand_scores / norm, NEG_INF)
        cand_codes = st.codes.index_select(0, cand_beam)
        cand_codes.scatter_(1, step.expand(2 * nb, 1), cand_tok[:, None])
        fin_scores, keep = top_first(torch.cat([st.fin_scores, fin]), nb)
        fin_codes = torch.cat([st.fin_codes, cand_codes]).index_select(0, keep)
        fin_lens = torch.cat([st.fin_lens, (step + 1).expand(2 * nb)]).index_select(0, keep)

        # the next beams: the first nb candidates that are not eos
        beam_scores, pos = top_first(torch.where(is_eos, NEG_INF, cand_scores), nb)
        beam_idx, tok = cand_beam[pos], cand_tok[pos]
        codes = st.codes.index_select(0, beam_idx)
        codes.scatter_(1, step.expand(nb, 1), tok[:, None])
        penal = st.penal_mask.index_select(0, beam_idx)
        penal.scatter_(1, tok[:, None], True)
        for mine, new in ((st.beam_scores, beam_scores), (st.fin_scores, fin_scores),
                          (st.fin_codes, fin_codes), (st.fin_lens, fin_lens),
                          (st.codes, codes), (st.penal_mask, penal)):
            mine.copy_(torch.where(done, mine, new))
        # HF _reorder_cache: every cache component gathered by beam_idx over
        # the whole capacity, as the JAX loop does
        for c in st.caches:
            c.copy_(c.index_select(1, beam_idx))
        st.tok.copy_(tok)

        index = st.start + step
        valid = (index + 1).to(torch.int32).repeat(nb)
        emb = model.embed_mel_step(tok, step.expand(nb))
        hidden = model.gpt_decode_step(emb, st.caches, index.expand(nb), valid,
                                       st.hole_s, st.hole_e)
        st.logits.copy_(model.mel_logits_from_hidden(hidden[:, 0]))
        st.step.add_((~done).long())
        st.finished.copy_(done.expand(nb))

    @staticmethod
    def _beam_result(st: BeamState, max_new: int) -> GenerateResult:
        """The best hypothesis (JAX `:811-822`): the pool and the beams
        still active, these normalized at S + step with length `step`, the
        first of the highest score. One row."""
        nb, step = st.tok.shape[0], st.step
        norm = (st.start + step).float() ** st.length_penalty
        scores = torch.cat([st.fin_scores, st.beam_scores / norm])
        codes = torch.cat([st.fin_codes, st.codes])[:, :max_new]
        lengths = torch.cat([st.fin_lens, step.expand(nb)])
        best = torch.argmax(scores)
        return GenerateResult(codes=codes[best][None], lengths=lengths[best][None])

    @torch.inference_mode()
    def generate_beam(self, conds_latent, text_ids, text_pos, text_valid,
                      seed: Optional[int], max_new: int, num_beams: int = 3,
                      repetition_penalty_value: float = 10.0, length_penalty: float = 0.0,
                      do_sample: bool = False, temperature: float = 1.0, top_p: float = 1.0,
                      eager: bool = False, cond_kv=None) -> GenerateResult:
        """Beam search for one request (B=1; the rows carry its num_beams
        beams), as JAX `generate_beam` (indextts_tpu/runtime/decode.py:
        835-866): deterministic, or with `do_sample` beam-multinomial (the
        reference's default), its draws from the decoder's generator
        seeded with `seed`. The prompt is prefilled once, on top of
        `cond_kv` when given, and copied into every beam. Up to max_new
        steps, the last finishing early on HF's is_done; on the card each
        is a replay of the captured step (`eager` runs them eagerly, the
        yardstick). Returns the best hypothesis: its codes, stop-padded,
        and its length, the eos included when it has one."""
        if cond_kv is not None and not self.supports_cond_kv:
            raise ValueError(f"cond_kv on a decoder whose layout prefills whole "
                             f"(attn_impl={self.attn_impl!r}, kv_int8={self.kv_int8})")
        if num_beams < 2:
            raise ValueError(f"num_beams={num_beams}: beam search takes 2 or more")
        with self._lock:
            t0 = time.perf_counter()
            with self._on_request(seed):
                st = self.prefill(conds_latent, text_ids, text_pos, text_valid, max_new,
                                  cond_kv, num_beams=num_beams)
                self._reset_beam(st, temperature, top_p, repetition_penalty_value,
                                 length_penalty)
                self._steps(st, self._beam_step, do_sample, max_new, eager,
                            until_finished=True)
            res = self._beam_result(st, max_new)
            self.tokens += int(res.lengths.sum())
            self.seconds += time.perf_counter() - t0
        return res

    # -- continuous batching ------------------------------------------------
    # The counterpart of the JAX decoder's prefill_request, insert_slot and
    # step_chunk (indextts_tpu/runtime/decode.py:881-1058): requests join
    # and leave the rows of one SlotState between chunks of steps
    # (runtime/batcher.py holds the host side).

    @torch.inference_mode()
    def slot_state(self, n_slots: int, cap: int, max_new: int, temperature: float,
                   top_p: float, penalty: float, seed: int) -> SlotState:
        """A SlotState on the decoder's device, with its sampling scalars
        and its own generator seeded once with `seed`."""
        with self.on_stream():
            st = SlotState(self.cfg, self.heads, n_slots, cap, max_new, self.kv_int8,
                           self.device, torch.Generator(device=self.device).manual_seed(seed),
                           self.model.gpt.dtype)
            st.temperature.fill_(temperature)
            st.top_p.fill_(top_p)
            st.penalty.fill_(penalty)
        return st

    def prefill_request(self, st: SlotState, slot: int, conds_latent, text_ids, text_pos,
                        text_valid):
        """Prefill one request (B=1) into row `slot`: its KV into the row's
        slots [0, S), quantized on insert with `kv_int8`; its last logits;
        pos S, no codes (all stop), not finished, active; its prompt hole;
        the fake-prompt penalty set (`_fake_prompt_penalty`). Runs on
        the current stream, the host reading nothing."""
        logits, prompt_kv, prompt_mask = self._prompt_prefill(
            conds_latent, text_ids, text_pos, text_valid)
        S = prompt_mask.shape[1]
        if S + st.max_new > st.cap:
            raise ValueError(f"prompt of {S} + {st.max_new} codes exceeds the slot "
                             f"caches' {st.cap} keys")
        for c, t in zip(st.caches, prompt_kv):
            c[:, slot, :, :S].copy_(t[:, 0])
        st.logits[slot].copy_(logits[0])
        hole_s, hole_e = prompt_hole(prompt_mask)
        st.hole_s[slot].copy_(hole_s[0])
        st.hole_e[slot].copy_(hole_e[0])
        st.pos[slot].fill_(S)
        st.gen_count[slot].fill_(0)
        st.finished[slot].fill_(False)
        st.active[slot].fill_(True)
        self._fake_prompt_penalty(st.penal_mask[slot])
        st.codes[slot].fill_(self.cfg.stop_mel_token)

    def slot_step(self, st: SlotState, do_sample: bool):
        """One step of every row, as the body of JAX `_step_chunk`: pick
        from the processed logits (`_processed`); an idle row (finished or inactive) takes
        stop and writes no code; codes go at gen_count; a row finishes on
        stop or at max_new codes; the penalty scatter; the code's embedding
        at mel position gen_count + 2 (the count before this code); the
        forward at slot pos, keys < pos + 1 attending; pos + 1 for a row
        that was not idle. An idle row's forward writes its cache's last
        slot and attends to one key; its outputs are not read. No write of
        a live row is clamped: pos < S + max_new <= cap.

        JAX bounds its attention reads per chunk by the deepest row
        (`prefix_limit`, batcher.py:209-222); K1 and K4 need no counterpart,
        their work already follows each row's valid_len."""
        model, stop = self.model, self.cfg.stop_mel_token
        idle = st.finished | ~st.active
        live = (~idle).long()
        tok = torch.where(idle, stop, self._choose(st, do_sample))
        st.codes.scatter_(1, torch.where(idle, st.cap - 1, st.gen_count)[:, None], tok[:, None])
        emb = model.embed_mel_step(tok, st.gen_count.clamp(max=st.max_new - 1))
        st.gen_count.add_(live)
        st.finished.logical_or_((tok == stop) | (st.gen_count >= st.max_new))
        st.penal_mask.scatter_(1, tok[:, None], True)
        write = torch.where(idle, st.cap - 1, st.pos)
        valid = torch.where(idle, 1, st.pos + 1).to(torch.int32)
        hidden = model.gpt_decode_step(emb, st.caches, write, valid, st.hole_s, st.hole_e)
        st.logits.copy_(model.mel_logits_from_hidden(hidden[:, 0]))
        st.pos.add_(live)

    def step_chunk(self, st: SlotState, chunk: int, do_sample: bool, eager: bool = False):
        """`chunk` steps of every row, on the current stream. On the card,
        unless `eager`, the step is captured once per state and do_sample
        and replayed (the JAX loop's early exit once every row is idle has
        no counterpart: an idle row's steps change nothing it keeps)."""
        self._steps(st, self.slot_step, do_sample, chunk, eager)

    @staticmethod
    def read_slots(st: SlotState) -> np.ndarray:
        """The host's one read of a chunk: (n_slots, 2 + max_new) int64, each
        row's finished flag, gen_count and codes."""
        return torch.cat([st.finished[:, None].long(), st.gen_count[:, None],
                          st.codes[:, :st.max_new]], dim=1).cpu().numpy()

"""Autoregressive decode loop for UnifiedVoice (sampling and greedy routes).

Counterpart of indextts_tpu/runtime/decode.py `GPTDecoder.generate`: prefill
[conds][right-aligned text][start_mel] once, then one token per step against
a KV cache in its natural layout (L, B, H, cap, Dh), attention over keys <
valid_len outside the prompt's left-pad hole. The cache is float (kernel K1)
or, with `kv_int8` (the JAX package's `kv_quant` or `attn_impl="pallas_q8"`),
int8 with per-(layer, row, head, token) f32 scales (kernel K4): the prefill
KV is quantized once with `quantize_kv`, and each step quantizes and writes
its own token's K/V and scales in place. Warper order as
HF: repetition penalty (the fake-prompt tokens {1, start_mel} included,
model_v2.py:785-794) -> temperature -> top-k -> top-p -> draw; greedy takes
the argmax after the penalty. Codes are stop-padded; lengths count the stop
token.

Not here: beam search, cond-prefill KV reuse, batched and continuous routes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.gpt2 import prompt_hole, quantize_kv
from indextts_tpu_torch.models.unified_voice import UnifiedVoice

NEG_INF = -1e9
# decode steps between host checks for "every row finished"
FINISH_CHECK_EVERY = 16


@dataclass(frozen=True)
class SamplingConfig:
    do_sample: bool = True
    top_k: int = 30


@dataclass
class GenerateResult:
    codes: torch.Tensor  # (B, max_new) int64, stop-token padded
    lengths: torch.Tensor  # (B,) — generated length INCLUDING the stop token


def repetition_penalty(logits, penal_mask, penalty: float):
    """HF RepetitionPenaltyLogitsProcessor: score<0 ? score*p : score/p."""
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(penal_mask, penalized, logits)


def warp_top_k_top_p(logits, temperature: float, top_p: float, top_k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """temperature -> top-k -> top-p on the descending top-k subset. Returns
    (vals, idx) (B, k): kept logits, NEG_INF where top-p drops a token."""
    logits = logits / temperature
    vals, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[:, 0] = True
    return torch.where(keep, vals, torch.full_like(vals, NEG_INF)), idx


def sample_top_k_top_p(logits, generator: torch.Generator, temperature: float,
                       top_p: float, top_k: int):
    vals, idx = warp_top_k_top_p(logits, temperature, top_p, top_k)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)
    return torch.gather(idx, 1, choice)[:, 0]


class GPTDecoder:
    def __init__(self, model: UnifiedVoice, cfg: GPTConfig,
                 sampling: SamplingConfig = SamplingConfig(), kv_int8: bool = False):
        self.model = model
        self.cfg = cfg
        self.sampling = sampling
        self.kv_int8 = kv_int8
        # cumulative decode counters (tokens emitted, wall seconds in generate)
        self.tokens = 0
        self.seconds = 0.0

    def build_text_prompt_arrays(self, text_ids: np.ndarray, text_lens: np.ndarray,
                                 bucket: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Place [start][text][stop] right-aligned in a (B, bucket+2) buffer
        (prepare_gpt_inputs left-padding, model_v2.py:749-779)."""
        B = text_ids.shape[0]
        L = bucket + 2
        ids = np.zeros((B, L), dtype=np.int64)
        pos = np.zeros((B, L), dtype=np.int64)
        valid = np.zeros((B, L), dtype=bool)
        for b in range(B):
            n = int(text_lens[b])
            seq = [self.cfg.start_text_token] + list(text_ids[b, :n]) + [
                self.cfg.stop_text_token]
            off = L - len(seq)
            ids[b, off:] = seq
            pos[b, off:] = np.arange(len(seq))
            valid[b, off:] = True
        return ids, pos, valid

    def prefill(self, conds_latent, text_ids, text_pos, text_valid, max_new: int):
        """Prompt prefill into fresh caches of capacity S + max_new. Returns
        (last_logits (B, V), caches, S, prompt_mask); caches are (ks, vs), or
        (ks, vs, ksc, vsc) with `kv_int8`."""
        model = self.model
        B = conds_latent.shape[0]
        dev = conds_latent.device
        text_emb = model.embed_text_prompt(text_ids, text_pos, text_valid)
        start_emb = model.embed_mel_start(B, dev)
        prompt = torch.cat([conds_latent, text_emb, start_emb], dim=1)
        ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
        prompt_mask = torch.cat(
            [ones.expand(B, conds_latent.shape[1]), text_valid, ones], dim=1)
        hidden, (pk, pv) = model.gpt_prefill(prompt, prompt_mask)
        S = pk.shape[3]
        if self.kv_int8:
            (pk, pksc), (pv, pvsc) = quantize_kv(pk), quantize_kv(pv)
            prompt_kv = (pk, pv, pksc, pvsc)
        else:
            prompt_kv = (pk, pv)
        caches = []
        for t in prompt_kv:
            c = t.new_zeros(t.shape[:3] + (S + max_new,) + t.shape[4:])
            c[:, :, :, :S] = t
            caches.append(c)
        caches = tuple(caches)
        logits = model.mel_logits_from_hidden(hidden[:, -1])
        return logits, caches, S, prompt_mask

    def initial_penalty_mask(self, B: int, device) -> torch.Tensor:
        """The HF fake-prompt tokens {1, start_mel} start in the penalty set."""
        mask = torch.zeros((B, self.cfg.number_mel_codes), dtype=torch.bool, device=device)
        mask[:, 1] = True
        mask[:, self.cfg.start_mel_token] = True
        return mask

    @torch.inference_mode()
    def generate(self, conds_latent, text_ids, text_pos, text_valid,
                 generator: Optional[torch.Generator], max_new: int,
                 temperature: float = 0.8, top_p: float = 0.8,
                 repetition_penalty_value: float = 10.0,
                 do_sample: Optional[bool] = None) -> GenerateResult:
        t0 = time.perf_counter()
        cfg, s, model = self.cfg, self.sampling, self.model
        do_sample = s.do_sample if do_sample is None else do_sample
        B = conds_latent.shape[0]
        dev = conds_latent.device
        stop = cfg.stop_mel_token
        logits, caches, S, prompt_mask = self.prefill(
            conds_latent, text_ids, text_pos, text_valid, max_new)
        # the left-pad hole is fixed for the whole request
        hole_s, hole_e = prompt_hole(prompt_mask)
        penal_mask = self.initial_penalty_mask(B, dev)
        codes = torch.full((B, max_new), stop, dtype=torch.long, device=dev)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        rows = torch.arange(B, device=dev)
        for step in range(max_new):
            lg = repetition_penalty(logits, penal_mask, repetition_penalty_value)
            if do_sample:
                tok = sample_top_k_top_p(lg, generator, temperature, top_p, s.top_k)
            else:
                tok = torch.argmax(lg, dim=-1)
            tok = torch.where(finished, torch.full_like(tok, stop), tok)
            codes[:, step] = tok
            finished = finished | (tok == stop)
            penal_mask[rows, tok] = True
            if step == max_new - 1:
                break
            if step % FINISH_CHECK_EVERY == FINISH_CHECK_EVERY - 1 and bool(finished.all()):
                break
            emb = model.embed_mel_step(tok, step)
            valid = torch.full((B,), S + step + 1, dtype=torch.int32, device=dev)
            hidden = model.gpt_decode_step(emb, caches, S + step, valid, hole_s, hole_e)
            logits = model.mel_logits_from_hidden(hidden[:, 0])
        is_stop = codes == stop
        first = torch.argmax(is_stop.int(), dim=1)
        lengths = torch.where(is_stop.any(dim=1), first + 1,
                              torch.full_like(first, max_new))
        self.tokens += int(lengths.sum())
        self.seconds += time.perf_counter() - t0
        return GenerateResult(codes=codes, lengths=lengths)

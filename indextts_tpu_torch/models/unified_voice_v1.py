"""UnifiedVoice v1: the IndexTTS v1 mel-conditioned autoregressive GPT.

Counterpart of indextts_tpu/models/unified_voice_v1.py (reference
indextts/gpt/model.py:332-782). The GPT-2 skeleton of UnifiedVoice
(models/unified_voice.py), but:

- the conditioning is a 100-bin mel (the conformer's input_size 100)
  resampled to 32 perceiver latents, with no emotion vector and no
  duration tokens: the prompt's conditioning is 32 positions wide, not 34;
- `forward_latent` takes the wavs' lengths in samples, the codes' being
  ceil(wav / mel_length_compression) + 1 (model.py:608-610), and runs the
  GPT without a padding mask, as the JAX module does: the text past a row's
  length is stop tokens, attended.

The decode hooks that runtime/decode.py `GPTDecoder` calls are
UnifiedVoice's own, with the same contracts; the decoder takes the
conditioning's width from its shape. `quantize`, `head_quant` and `gemv`
are UnifiedVoice's, at 8 bits only (the JAX v1 engine quantizes no
further). No module holds the text head that the reference checkpoint
carries (inference never calls it). Module names follow the reference
state_dict.
"""

from __future__ import annotations

import torch
from torch import nn

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.conformer import ConformerEncoder
from indextts_tpu_torch.models.gpt2 import GPT2Core, QuantDenseHead
from indextts_tpu_torch.models.layers import LayerNorm, Linear
from indextts_tpu_torch.models.perceiver import PerceiverResampler
from indextts_tpu_torch.models.unified_voice import LearnedPositionEmbeddings, UnifiedVoice


class UnifiedVoiceV1(nn.Module):
    embed_text_prompt = UnifiedVoice.embed_text_prompt
    embed_mel_start = UnifiedVoice.embed_mel_start
    embed_mel_step = UnifiedVoice.embed_mel_step
    mel_logits_from_hidden = UnifiedVoice.mel_logits_from_hidden
    gpt_prefill = UnifiedVoice.gpt_prefill
    gpt_prefill_with_past = UnifiedVoice.gpt_prefill_with_past
    gpt_decode_step = UnifiedVoice.gpt_decode_step

    def __init__(self, cfg: GPTConfig, quantize: bool = False, head_quant: bool = False,
                 gemv: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.conditioning_encoder = ConformerEncoder(c.condition_module)
        self.perceiver_encoder = PerceiverResampler(
            c.model_dim, c.condition_module.output_size, c.condition_num_latent,
            heads=c.condition_module.attention_heads,
            ff_mult=c.condition_module.perceiver_mult,
        )
        self.text_embedding = nn.Embedding(c.number_text_tokens + 1, c.model_dim)
        self.mel_embedding = nn.Embedding(c.number_mel_codes, c.model_dim)
        self.mel_pos_embedding = LearnedPositionEmbeddings(c.max_mel_position, c.model_dim)
        self.text_pos_embedding = LearnedPositionEmbeddings(c.max_text_position, c.model_dim)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.mel_head = (QuantDenseHead(c.model_dim, c.number_mel_codes, gemv) if head_quant
                         else Linear(c.model_dim, c.number_mel_codes))
        self.gpt = GPT2Core(c.layers, c.model_dim, c.heads, quantize, gemv)

    def get_conditioning(self, cond_mel, cond_lens):
        """(B, T, 100) mel, frames first -> (B, 32, model_dim) latents."""
        enc, mask = self.conditioning_encoder(cond_mel, cond_lens)
        lat = torch.ones((mask.shape[0], self.cfg.condition_num_latent),
                         dtype=torch.bool, device=mask.device)
        return self.perceiver_encoder(enc, torch.cat([lat, mask], dim=1))

    def forward_latent(self, cond_mel, cond_lens, text_ids, text_lens, mel_codes, wav_lens):
        """The teacher-forced latent pass (model.py:571-650, return_latent):
        text_ids (B, Lt) raw ids, mel_codes (B, Lm), wav_lens (B,) in
        samples. Returns the final-normed hidden state of the first Lm mel
        positions, (B, Lm, model_dim) float32."""
        c = self.cfg
        B, Lt = text_ids.shape
        Lm = mel_codes.shape[1]
        dev = text_ids.device
        conds = self.get_conditioning(cond_mel, cond_lens)
        mel_lens = torch.ceil(wav_lens.float() / c.mel_length_compression).long() + 1

        def framed(ids, lens, start, stop):
            pos = torch.arange(ids.shape[1], device=dev)
            ids = torch.where(pos[None] < lens[:, None], ids, stop).long()
            return torch.cat([torch.full((B, 1), start, device=dev), ids,
                              torch.full((B, 1), stop, device=dev)], dim=1)

        text_emb = self.text_embedding(
            framed(text_ids, text_lens, c.start_text_token, c.stop_text_token)
        ) + self.text_pos_embedding(torch.arange(Lt + 2, device=dev)[None])
        mel_emb = self.mel_embedding(
            framed(mel_codes, mel_lens, c.start_mel_token, c.stop_mel_token)
        ) + self.mel_pos_embedding(torch.arange(Lm + 2, device=dev)[None])
        hidden, _ = self.gpt(torch.cat([conds, text_emb, mel_emb], dim=1))
        enc = self.final_norm(hidden[:, conds.shape[1]:].float())
        return enc[:, -(Lm + 2):][:, :Lm]

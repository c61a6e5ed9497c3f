"""UnifiedVoice: the autoregressive GPT acoustic-token model.

Counterpart of indextts_tpu/models/unified_voice.py (reference
gpt/model_v2.py:338-910): conformer+perceiver speaker conditioning (32
latents), emotion conditioning (1 latent @1024 -> emovec_layer -> emo_layer),
two duration tokens, GPT-2 core over [conds][text][mel], learned position
embeddings, final_norm + mel_head. The training head `text_head` is built
only for a training model (`text_head=True`; runtime/train.py), whose
`forward_train` gives the text and mel logits of the JAX package's; a
serving model holds no text_head. Module names follow the reference
state_dict.

`quantize=True` builds the quantized GPT-2 blocks of `wbits` bits (8 or 4)
and `head_quant=True` the int8 logits head (models/gpt2.py), as the JAX
package's `quantize_gpt`, `wbits` and `head_quant`; embeddings, norms and
the conditioning stay float. Stored in bfloat16 (the engine's gpt_dtype),
the conformers, perceivers and GPT blocks compute in bfloat16 as the JAX
modules with dtype=bfloat16; the emotion projections, the final norm and
the head promote with their input (models/layers.py): the final norm and
the logits are float32, and merge_emovec returns float32, as the JAX
engine's emovec. `gemv=True` sends the blocks' and the head's
single-row decode calls through the kernels of ops/gemv.py, as the JAX
package's `gemv_impl="pallas"`; `gemv=False` is its "xla" route.
"""

from __future__ import annotations

import torch
from torch import nn

from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.models.conformer import ConformerEncoder
from indextts_tpu_torch.models.gpt2 import GPT2Core, QuantDenseHead
from indextts_tpu_torch.models.layers import LayerNorm, Linear
from indextts_tpu_torch.models.perceiver import PerceiverResampler


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(n, dim)

    def forward(self, pos):
        return self.emb(pos)


class UnifiedVoice(nn.Module):
    def __init__(self, cfg: GPTConfig, quantize: bool = False, head_quant: bool = False,
                 wbits: int = 8, gemv: bool = False, text_head: bool = False):
        super().__init__()
        self.cfg = c = cfg
        self.conditioning_encoder = ConformerEncoder(c.condition_module)
        self.perceiver_encoder = PerceiverResampler(
            c.model_dim, c.condition_module.output_size, c.condition_num_latent,
            heads=c.condition_module.attention_heads,
            ff_mult=c.condition_module.perceiver_mult,
        )
        self.emo_conditioning_encoder = ConformerEncoder(c.emo_condition_module)
        self.emo_perceiver_encoder = PerceiverResampler(
            1024, c.emo_condition_module.output_size, 1,
            heads=c.emo_condition_module.attention_heads,
            ff_mult=c.emo_condition_module.perceiver_mult,
        )
        self.text_embedding = nn.Embedding(c.number_text_tokens + 1, c.model_dim)
        self.mel_embedding = nn.Embedding(c.number_mel_codes, c.model_dim)
        self.mel_pos_embedding = LearnedPositionEmbeddings(c.max_mel_position, c.model_dim)
        self.text_pos_embedding = LearnedPositionEmbeddings(c.max_text_position, c.model_dim)
        self.speed_emb = nn.Embedding(2, c.model_dim)
        self.emovec_layer = Linear(1024, c.model_dim)
        self.emo_layer = Linear(c.model_dim, c.model_dim)
        self.final_norm = LayerNorm(c.model_dim, eps=1e-5)
        self.mel_head = (QuantDenseHead(c.model_dim, c.number_mel_codes, gemv) if head_quant
                         else Linear(c.model_dim, c.number_mel_codes))
        self.gpt = GPT2Core(c.layers, c.model_dim, c.heads, quantize, gemv, wbits)
        if text_head:
            self.text_head = Linear(c.model_dim, c.number_text_tokens + 1)

    # -- conditioning ------------------------------------------------------

    def get_conditioning(self, cond_emb, cond_lens):
        """(B, T, 1024) w2v-BERT features -> (B, 32, model_dim) latents."""
        enc, mask = self.conditioning_encoder(cond_emb, cond_lens)
        lat = torch.ones((mask.shape[0], self.cfg.condition_num_latent),
                         dtype=torch.bool, device=mask.device)
        return self.perceiver_encoder(enc, torch.cat([lat, mask], dim=1))

    def get_emo_conditioning(self, cond_emb, cond_lens):
        enc, mask = self.emo_conditioning_encoder(cond_emb, cond_lens)
        lat = torch.ones((mask.shape[0], 1), dtype=torch.bool, device=mask.device)
        return self.emo_perceiver_encoder(enc, torch.cat([lat, mask], dim=1))[:, 0]

    def get_emovec(self, emo_cond_emb, emo_cond_lens):
        return self.emo_layer(self.emovec_layer(
            self.get_emo_conditioning(emo_cond_emb, emo_cond_lens)))

    def merge_emovec(self, spk_cond_emb, emo_cond_emb, spk_lens, emo_lens,
                     alpha: float = 1.0):
        """base + alpha * (emo - base) (model_v2.py:904-910), float32: the
        JAX engine's alpha is a float32 array, which promotes a bfloat16
        model's difference."""
        emo = self.get_emovec(emo_cond_emb, emo_lens)
        base = self.get_emovec(spk_cond_emb, spk_lens)
        return base.float() + alpha * (emo - base).float()

    def build_conds_latent(self, spk_latents, emovec):
        """[spk_latents + emovec, speed_emb(1), speed_emb(0)] -> (B, 34, D)."""
        B = spk_latents.shape[0]
        # speed_emb rows 1 then 0, read on the device: an index tensor made
        # here would be a host-to-device copy, which a CUDA graph capture
        # refuses
        dur = self.speed_emb.weight.flip(0)[None].expand(B, -1, -1)
        return torch.cat([spk_latents + emovec[:, None, :], dur], dim=1)

    # -- prompt / step embeddings for the decode loop -------------------------

    def embed_text_prompt(self, text_ids, text_pos, text_valid):
        """Right-aligned text ids -> embeddings, zeroed on left-pad slots."""
        emb = self.text_embedding(text_ids) + self.text_pos_embedding(text_pos)
        return emb.masked_fill(~text_valid[..., None], 0.0)

    def embed_mel_start(self, batch: int, device):
        tok = torch.full((batch, 1), self.cfg.start_mel_token, device=device)
        return self.mel_embedding(tok) + self.mel_pos_embedding(torch.zeros_like(tok))

    def embed_mel_step(self, tokens, step: torch.Tensor):
        """Embed one decode-step token a row at mel position step + 2: the
        reference's get_fixed_embedding skips position 1
        (model_v2.py:174-177), a quirk kept here. `step` is a (B,) integer
        tensor on the tokens' device, each row's code index (the JAX step
        broadcasts its per-row `gen_count` the same way), so a captured step
        reads it in place."""
        emb = self.mel_embedding(tokens[:, None])
        return emb + self.mel_pos_embedding((step + 2)[:, None])

    def mel_logits_from_hidden(self, hidden):
        return self.mel_head(self.final_norm(hidden.float()))

    def gpt_prefill(self, inputs_embeds, attention_mask):
        return self.gpt(inputs_embeds, attention_mask)

    def gpt_prefill_with_past(self, inputs_embeds, attention_mask, past_kv):
        """The prefill of `inputs_embeds` (B, T, D) after the cached float KV
        `past_kv` (ks, vs), each (L, B or 1, H, P, Dh): hidden (B, T, D) and
        the KV of all P + T positions (GPT2Core.forward with `past`)."""
        return self.gpt(inputs_embeds, attention_mask, past=past_kv)

    def gpt_decode_step(self, token_embeds, caches, index, valid_len, hole_s, hole_e):
        """caches: (ks, vs) float or (ks, vs, ksc, vsc) int8 + scales;
        index (B,) and valid_len (B,) integer tensors (GPT2Core.decode_step)."""
        return self.gpt.decode_step(token_embeds, caches, index, valid_len,
                                    hole_s, hole_e)

    # -- training forward: text + mel logits with aligned targets ------------

    def forward_train(self, spk_latents, text_ids, text_lens, mel_codes, mel_lens, emovec):
        """text_ids (B, Lt), mel_codes (B, Lm); slots past text_lens and
        mel_lens are the stop tokens. Returns (text_logits (B, Lt+2, V_text),
        mel_logits (B, Lm+2, V_mel), text_targets, mel_targets), the targets
        the sequences shifted right by one with two stop tokens after (the
        JAX package's UnifiedVoice.forward_train). The GPT runs with no
        padding mask, as there."""
        c = self.cfg
        B, Lt = text_ids.shape
        Lm = mel_codes.shape[1]
        dev = text_ids.device

        def framed(ids, lens, start, stop):
            pos = torch.arange(ids.shape[1], device=dev)
            ids = torch.where(pos[None] < lens[:, None], ids, stop).long()
            inp = torch.cat([torch.full((B, 1), start, device=dev), ids,
                             torch.full((B, 1), stop, device=dev)], dim=1)
            return inp, torch.cat([ids, torch.full((B, 2), stop, device=dev)], dim=1)

        text_inp, text_tar = framed(text_ids, text_lens, c.start_text_token, c.stop_text_token)
        mel_inp, mel_tar = framed(mel_codes, mel_lens, c.start_mel_token, c.stop_mel_token)
        text_emb = self.text_embedding(text_inp) + self.text_pos_embedding(
            torch.arange(Lt + 2, device=dev)[None])
        mel_emb = self.mel_embedding(mel_inp) + self.mel_pos_embedding(
            torch.arange(Lm + 2, device=dev)[None])
        conds = self.build_conds_latent(spk_latents, emovec)
        hidden, _ = self.gpt(torch.cat([conds, text_emb, mel_emb], dim=1))
        enc = self.final_norm(hidden[:, conds.shape[1]:].float())
        return (self.text_head(enc[:, :Lt + 2]), self.mel_head(enc[:, -(Lm + 2):]),
                text_tar, mel_tar)

    # -- teacher-forced latent pass (model_v2.py:673-723) ----------------------

    def forward_latent(self, spk_latents, text_ids, text_lens, mel_codes,
                       mel_lens, emovec):
        """text_ids (B, Lt) raw ids; mel_codes (B, Lm) stop-trimmed codes.
        Returns (B, Lm, model_dim)."""
        c = self.cfg
        B, Lt = text_ids.shape
        Lm = mel_codes.shape[1]
        dev = text_ids.device
        pos_t = torch.arange(Lt, device=dev)
        text_ids = torch.where(pos_t[None] < text_lens[:, None], text_ids,
                               c.stop_text_token)
        start_t = torch.full((B, 1), c.start_text_token, device=dev, dtype=text_ids.dtype)
        stop_t = torch.full((B, 1), c.stop_text_token, device=dev, dtype=text_ids.dtype)
        text_full = torch.cat([start_t, text_ids, stop_t], dim=1)
        text_emb = self.text_embedding(text_full) + self.text_pos_embedding(
            torch.arange(Lt + 2, device=dev)[None])
        pos_m = torch.arange(Lm, device=dev)
        mel_codes = torch.where(pos_m[None] < mel_lens[:, None], mel_codes,
                                c.stop_mel_token)
        start_m = torch.full((B, 1), c.start_mel_token, device=dev, dtype=mel_codes.dtype)
        stop_m = torch.full((B, 1), c.stop_mel_token, device=dev, dtype=mel_codes.dtype)
        mel_full = torch.cat([start_m, mel_codes, stop_m], dim=1)
        mel_emb = self.mel_embedding(mel_full) + self.mel_pos_embedding(
            torch.arange(Lm + 2, device=dev)[None])
        conds = self.build_conds_latent(spk_latents, emovec)
        emb = torch.cat([conds, text_emb, mel_emb], dim=1)
        mask_t = torch.arange(Lt + 2, device=dev)[None] < (text_lens[:, None] + 2)
        mask_m = torch.arange(Lm + 2, device=dev)[None] < (mel_lens[:, None] + 2)
        mask = torch.cat([torch.ones((B, conds.shape[1]), dtype=torch.bool, device=dev),
                          mask_t, mask_m], dim=1)
        hidden, _ = self.gpt(emb, mask)
        enc = self.final_norm(hidden[:, conds.shape[1]:].float())
        return enc[:, -(Lm + 2):][:, :Lm]

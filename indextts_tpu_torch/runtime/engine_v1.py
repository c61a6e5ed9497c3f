"""IndexTTS v1 inference engine: the mel-conditioned GPT, its latents, and the
v1 BigVGAN (latents in, the speaker's reference mel as conditioning).

Counterpart of indextts_tpu/runtime/engine_v1.py (reference
indextts/infer.py IndexTTS, its `infer_fast` path :296-529). The prompt is
resampled to 24 kHz and turned into the v1 mel (`mel_spectrogram_v1`,
100 bins), cached under a key when the caller gives one; the GPT's 32
conditioning latents come from it once a request. The segments are
grouped by length into buckets of at most `bucket_max_size`
(`bucket_segments`); each bucket is one `GPTDecoder.generate` over its B
rows (the texts right-aligned at the longest's width, each row its own
pad hole), seeded with seed + the bucket's first segment index as the JAX
engine seeds it, and on the card a replay of the decoder's captured step
a token. Every row's codes are cut at the stop token and their silent
runs compressed (`remove_long_silence`); then one latent pass and one
vocoder call over the B rows, the reference mel repeated a row, and with
`device_pcm16` the waveform clipped into int16 on the card. The segments
are joined with `interval_silence` ms of silence at 24 kHz.

The decode knobs are the v2 engine's: `quantize_gpt` (W8A8 blocks, the
float weights quantized here), `head_quant` (the int8 logits head, with
quantize_gpt), `kv_quant` (an int8 cache, K4), `attn_impl` and `gemv_impl`
("pallas": K5 and K6 for the blocks' and the head's single-row calls;
"auto" takes them on CUDA; the JAX v1 engine's default is "xla"),
resolved as `runtime/engine.py` `resolve_gemv`, and `gpt_dtype`. v1 samples at temperature 1.0, top_p 0.8 and repetition
penalty 10.0 by default (top_k 30), the reference's infer_fast defaults.

Runs on `cuda` unless the caller passes `device="cpu"`. Stage seconds of
the last request go to `last_stats` (conditioning, decode, host_trim,
latent, vocoder); under TARS_STAGE_SYNC=1 each stage ends in a wait for
the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from indextts_tpu_torch.config import GPTConfig, MelConfig
from indextts_tpu_torch.models.bigvgan import to_pcm16
from indextts_tpu_torch.models.bigvgan_v1 import BigVGANv1, BigVGANv1Config
from indextts_tpu_torch.models.unified_voice_v1 import UnifiedVoiceV1
from indextts_tpu_torch.ops import mel as mel_ops
from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, adopt, gemv_route
from indextts_tpu_torch.utils import audio as audio_utils
from indextts_tpu_torch.utils.device import resolve_device
from indextts_tpu_torch.weights import quantize_gpt_state_dict

SAMPLE_RATE = 24000


def bucket_segments(seg_lens: List[int], bucket_max_size: int = 4) -> List[List[int]]:
    """Segment indices grouped into decode batches of at most
    bucket_max_size, nearest lengths together: sorted by length (stable),
    then chunked (infer.py:204-260)."""
    order = sorted(range(len(seg_lens)), key=lambda i: seg_lens[i])
    return [order[i:i + bucket_max_size] for i in range(0, len(order), bucket_max_size)]


def v1_model(name: str, gpt_cfg: GPTConfig, voc_cfg: BigVGANv1Config, quantize: bool = False,
             head_quant: bool = False, gemv: bool = False) -> torch.nn.Module:
    """Model `name` ("gpt" or "bigvgan") of the v1 engine."""
    if name == "gpt":
        return UnifiedVoiceV1(gpt_cfg, quantize=quantize, head_quant=head_quant, gemv=gemv)
    return BigVGANv1(voc_cfg)


def random_params_v1(gpt_cfg: GPTConfig, voc_cfg: BigVGANv1Config, seed: int = 0,
                     device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random float state dicts {"gpt", "bigvgan"} drawn on `device` from
    `seed`: each module's own PyTorch initialization, and BatchNorm
    statistics drawn positive (running means U[-0.1, 0.1), variances
    U[0.5, 1.5)). As `random_params` (runtime/engine.py), the JAX
    package's U[0.01, 0.05) fill would make the full-width vocoder NaN."""
    dev = resolve_device(device)
    out = {}
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        for name in ("gpt", "bigvgan"):
            with torch.device(dev):
                sd = dict(v1_model(name, gpt_cfg, voc_cfg).state_dict())
            for key, v in sd.items():
                if key.endswith(".running_mean"):
                    v.uniform_(-0.1, 0.1)
                elif key.endswith(".running_var"):
                    v.uniform_(0.5, 1.5)
            out[name] = sd
    return out


class IndexTTSV1Engine:
    def __init__(
        self,
        gpt_cfg: GPTConfig,
        voc_cfg: BigVGANv1Config,
        params: Dict[str, Dict[str, torch.Tensor]],
        mel_cfg: Optional[MelConfig] = None,
        bucket_max_size: int = 4,
        gpt_dtype: torch.dtype = torch.float32,
        device_pcm16: bool = True,
        quantize_gpt: bool = False,
        kv_quant: bool = False,
        attn_impl: str = "xla",
        gemv_impl: str = "xla",
        head_quant: bool = False,
        device=None,
    ):
        """params: {"gpt", "bigvgan"} state dicts (weights.py
        unified_voice_v1_sd / bigvgan_v1_sd, the converters of
        runtime/torch_convert.py, or random_params_v1). A float GPT state
        dict is quantized here under quantize_gpt (a tree quantized by the
        JAX package's quantize_gpt_tree is taken as is)."""
        self.device = dev = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.gpt_cfg, self.voc_cfg = gpt_cfg, voc_cfg
        # the v1 conditioning mel: 24 kHz, 100 bins (config.yaml dataset.mel)
        self.mel_cfg = mel_cfg or MelConfig(sample_rate=SAMPLE_RATE, n_fft=1024,
                                            hop_length=256, win_length=1024, n_mels=100)
        self.bucket_max_size = bucket_max_size
        head_quant = head_quant and quantize_gpt
        gpt_sd = params["gpt"]
        if quantize_gpt and "gpt.h.0.attn.c_attn.weight" in gpt_sd:
            gpt_sd = quantize_gpt_state_dict(gpt_sd, head=head_quant)
        with torch.device("meta"):
            gpt = v1_model("gpt", gpt_cfg, voc_cfg, quantize_gpt, head_quant,
                           gemv_route(gemv_impl, dev))
            voc = v1_model("bigvgan", gpt_cfg, voc_cfg)
        self.gpt: UnifiedVoiceV1 = adopt(gpt, gpt_sd, dev, gpt_dtype)
        self.bigvgan: BigVGANv1 = adopt(voc, params["bigvgan"], dev)
        self.decoder = GPTDecoder(self.gpt, gpt_cfg, SamplingConfig(),
                                  kv_int8=kv_quant or attn_impl == "pallas_q8",
                                  attn_impl=attn_impl)
        self.device_pcm16 = bool(device_pcm16)
        self._cond_cache: Dict[str, Tuple[torch.Tensor, int]] = {}
        self._seed_gen = np.random.default_rng()
        self.last_stats: Dict[str, float] = {}

    _tensor = IndexTTS2Engine._tensor
    _stage_barrier = IndexTTS2Engine._stage_barrier

    @torch.inference_mode()
    def prepare_conditioning(self, audio: np.ndarray, sr: int, key: Optional[str] = None
                             ) -> Tuple[torch.Tensor, int]:
        """The prompt's v1 mel, frames first (1, T, 100), and T; cached
        under `key` when given."""
        if key is not None and key in self._cond_cache:
            return self._cond_cache[key]
        audio24 = audio_utils.resample(np.asarray(audio, np.float32), sr,
                                       self.mel_cfg.sample_rate)
        mel = mel_ops.mel_spectrogram_v1(self._tensor(audio24[None], torch.float32),
                                         self.mel_cfg)
        mel_t = mel.transpose(1, 2).contiguous()
        out = (mel_t, mel_t.shape[1])
        if key is not None:
            self._cond_cache[key] = out
        return out

    @torch.inference_mode()
    def infer_fast(
        self,
        spk_audio: Union[str, Tuple[np.ndarray, int]],
        text_ids_segments: List[np.ndarray],
        output_path: Optional[str] = None,
        interval_silence: int = 200,
        max_mel_tokens: int = 600,
        seed: Optional[int] = None,
        temperature: float = 1.0,
        top_p: float = 0.8,
        repetition_penalty: float = 10.0,
    ) -> dict:
        """Bucketed batched synthesis of pre-tokenized segments. Returns
        {"sampling_rate": 24000, "audio": float32 (T,), "duration_sec",
        "rtf"}."""
        t_start = time.perf_counter()
        stats: Dict[str, float] = {}
        t_mark = t_start

        def mark(name: str) -> None:
            nonlocal t_mark
            self._stage_barrier()
            now = time.perf_counter()
            stats[name] = stats.get(name, 0.0) + now - t_mark
            t_mark = now

        g = self.gpt_cfg
        if isinstance(spk_audio, str):
            audio, sr = audio_utils.load_wav(spk_audio)
            cond_mel, cond_len = self.prepare_conditioning(audio, sr, key=spk_audio)
        else:
            cond_mel, cond_len = self.prepare_conditioning(*spk_audio)
        conds = self.gpt.get_conditioning(cond_mel, self._tensor([cond_len]))
        mark("conditioning")

        seg_lens = [len(s) for s in text_ids_segments]
        wav_parts: List[Optional[np.ndarray]] = [None] * len(seg_lens)
        for batch_idx in bucket_segments(seg_lens, self.bucket_max_size):
            B = len(batch_idx)
            Lmax = max(seg_lens[i] for i in batch_idx)
            text = np.zeros((B, Lmax), np.int64)
            lens = np.zeros(B, np.int64)
            for bi, si in enumerate(batch_idx):
                text[bi, :seg_lens[si]] = text_ids_segments[si]
                lens[bi] = seg_lens[si]
            ids, pos, valid = self.decoder.build_text_prompt_arrays(text, lens, Lmax)
            bseed = (seed + batch_idx[0] if seed is not None
                     else int(self._seed_gen.integers(0, 2**62)))
            res = self.decoder.generate(
                conds.expand(B, -1, -1).contiguous(), self._tensor(ids), self._tensor(pos),
                self._tensor(valid), bseed, max_new=max_mel_tokens, temperature=temperature,
                top_p=top_p, repetition_penalty_value=repetition_penalty)
            codes, lengths = res.codes.cpu().numpy(), res.lengths.cpu().numpy()
            mark("decode")
            # stop-trim and silent-run compression, every row (infer.py:450,639)
            rows = [IndexTTS2Engine.remove_long_silence(codes[bi, :int(lengths[bi])],
                                                        g.stop_mel_token) for bi in range(B)]
            code_lens = np.maximum([n for _, n in rows], 1)
            codes_arr = np.full((B, int(code_lens.max())), g.stop_mel_token, np.int64)
            for bi, (row, _) in enumerate(rows):
                codes_arr[bi, :len(row)] = row  # an empty row stays stop-only
            wav_lens = code_lens * g.mel_length_compression
            mark("host_trim")
            ref = cond_mel.expand(B, -1, -1)
            latents = self.gpt.forward_latent(
                ref, self._tensor([cond_len] * B), self._tensor(text), self._tensor(lens),
                self._tensor(codes_arr), self._tensor(wav_lens))
            mark("latent")
            wav = self.bigvgan(latents, ref)
            if self.device_pcm16:
                wavs = to_pcm16(wav).cpu().numpy().astype(np.float32) / 32767.0
            else:
                wavs = wav.cpu().numpy()
            mark("vocoder")
            for bi, si in enumerate(batch_idx):
                wav_parts[si] = wavs[bi, :int(code_lens[bi]) * g.mel_length_compression]

        sil = np.zeros(int(SAMPLE_RATE * interval_silence / 1000.0), np.float32)
        pieces: List[np.ndarray] = []
        for i, w in enumerate(wav_parts):
            pieces.append(w if w is not None else np.zeros(0, np.float32))
            if i < len(wav_parts) - 1:
                pieces.append(sil)
        wav_out = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        total = time.perf_counter() - t_start
        dur = len(wav_out) / SAMPLE_RATE
        self.last_stats = stats
        if output_path:
            audio_utils.save_wav(output_path, wav_out, SAMPLE_RATE)
        return {"sampling_rate": SAMPLE_RATE, "audio": wav_out, "duration_sec": dur,
                "rtf": total / dur if dur else float("inf")}

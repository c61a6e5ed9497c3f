"""IndexTTS2 inference engine: the five-model cascade on one device.

Counterpart of indextts_tpu/runtime/engine.py `IndexTTS2Engine` on its
sequential route: prepare_speaker (w2v-BERT -> RepCodec, 22 kHz mel,
CAMPPlus, regulator, conformer+perceiver latents) -> per segment: emovec +
conds, AR decode, teacher-forced latent pass, gpt_layer + vq2emb + length
regulator, CFM (20 Euler steps, CFG), BigVGAN, on-device PCM16.

As in the JAX engine, `precise_shapes=False` (the default) runs the tail
of a segment at buckets (indextts_tpu/runtime/engine.py:724-827): the
latent pass over the codes padded with the stop token to a multiple of 64
and the text padded to a multiple of 64 (capped at max_text_tokens); s2mel
over that latent and those codes, its target mel length rounded up to a
multiple of 128 frames (the padding is masked: the valid lengths drive the
regulator, the DiT's attention and WaveNet's reflection), the mel sliced
back to the exact length; the vocoder over that mel padded to the bucket
with log(1e-5), the waveform cut to the exact length. The CFM noise is
drawn at the bucket's width in both modes, so each frame gets the same
noise either way. `precise_shapes=True` runs every stage at exact shapes.
On the card each stage is a replay of a CUDA graph captured per bucket
(runtime/graphs.py `LatentRunner`, `VocoderRunner`; runtime/s2mel_infer.py
`S2MelRunner`); `precompile` captures the serving envelope's graphs up
front, as the JAX engine compiles its programs. TARS_STAGE_SYNC=1 ends the
latent and s2mel stages with a wait for the card, so each stage's seconds
hold its device time, as in the JAX engine; by default nothing waits.

The quantized GPT route of the JAX package is honoured: `gpt_quantize`
(W8A8 blocks with `gpt_wbits=8`, W4A8 with `gpt_wbits=4`), `head_quant`
(int8 logits head, with gpt_quantize) and an int8 KV cache (`kv_quant`, or
`attn_impl="pallas_q8"`). The engine quantizes a float GPT state dict at
construction (a tree already quantized by the JAX package's
`quantize_gpt_tree` is taken as is) and keeps no float copy of the
quantized weights. `gemv_impl` resolves as in the JAX engine
(`resolve_gemv`), with the card in the TPU's place: the decode kernels of
ops/gemv.py run under "pallas", and under "auto" for W4 on CUDA only.

Routes the port does not implement raise NotImplementedError: beam search
(num_beams > 1), batched segments, emo_vector / use_emo_text, and bfloat16
s2mel or vocoder dtypes. `infer_continuous` decodes the segments in a
shared runtime/batcher.py ContinuousService.

The AR decode (runtime/decode.py `GPTDecoder`) replays a captured step on
the card; the engine hands it each request's seed (a random one for a
seedless request), from which the decoder reseeds its own generator.

Runs on `cuda` unless the caller passes `device="cpu"`. Float32 compute;
the constructor turns TF32 off for matmuls and cuDNN convolutions, which
PyTorch would otherwise use for float32 convolutions on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time
from dataclasses import dataclass
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from indextts_tpu_torch.config import IndexTTS2Config
from indextts_tpu_torch.frontend import features as feat
from indextts_tpu_torch.models.bigvgan import BigVGAN
from indextts_tpu_torch.models.campplus import CAMPPlus
from indextts_tpu_torch.models.repcodec import RepCodec
from indextts_tpu_torch.models.s2mel import S2Mel
from indextts_tpu_torch.models.unified_voice import UnifiedVoice
from indextts_tpu_torch.models.w2vbert import W2VBertEncoder
from indextts_tpu_torch.ops import mel as mel_ops
from indextts_tpu_torch.runtime.decode import GPTDecoder, SamplingConfig
from indextts_tpu_torch.runtime.graphs import LatentRunner, VocoderRunner
from indextts_tpu_torch.runtime.s2mel_infer import S2MelRunner
from indextts_tpu_torch.utils import audio as audio_utils
from indextts_tpu_torch.utils.device import resolve_device
from indextts_tpu_torch.weights import quantize_gpt_state_dict

# each model of the cascade, built from the config for the device it runs on
MODELS: Dict[str, Callable[[IndexTTS2Config, torch.device], torch.nn.Module]] = {
    "gpt": lambda c, dev: UnifiedVoice(c.gpt, quantize=c.runtime.gpt_quantize,
                                       head_quant=head_quant(c), wbits=c.runtime.gpt_wbits,
                                       gemv=resolve_gemv(c, dev)),
    "s2mel": lambda c, dev: S2Mel(c.s2mel),
    "bigvgan": lambda c, dev: BigVGAN(c.vocoder),
    "repcodec": lambda c, dev: RepCodec(c.semantic_codec),
    "campplus": lambda c, dev: CAMPPlus(c.campplus),
    "w2vbert": lambda c, dev: W2VBertEncoder(c.w2vbert),
}


def next_bucket(n: int, step: int, minimum: int = 0) -> int:
    """n rounded up to a multiple of step, at least minimum (the JAX
    engine's next_bucket)."""
    return max(minimum, step * (-(-n // step)))


class PrecompileGrid(NamedTuple):
    """The programs of the serving envelope, one job each."""

    text_buckets: List[int]  # decode prompts
    latent: List[Tuple[int, int]]  # (text width, code width)
    s2mel: List[Tuple[int, int, int]]  # (code bucket, target bucket, a code length reaching both)
    vocoder: List[int]  # mel widths: the target buckets


def precompile_grid(max_text_tokens: int, max_text_tokens_per_segment: int,
                    text_buckets: Optional[Sequence[int]] = None, max_code_len: int = 512,
                    code_lens: Optional[Sequence[int]] = None) -> PrecompileGrid:
    """The JAX engine's precompile grid (indextts_tpu/runtime/engine.py:
    1051-1101): decode text buckets every 16 tokens up to the segment cap;
    the latent pass's text buckets (64-step, capped at max_text_tokens) x
    its code buckets; the (code bucket, target bucket) pairs that some code
    length in [1, max_code_len] (or in `code_lens`) reaches; their target
    buckets for the vocoder."""
    mt = max_text_tokens
    if text_buckets is None:
        cap_t = min(next_bucket(max_text_tokens_per_segment, 16, 16), mt)
        text_buckets = range(16, cap_t + 1, 16)
    text_buckets = sorted({min(int(b), mt) for b in text_buckets})
    combos: Dict[Tuple[int, int], int] = {}
    for cl in (range(1, max_code_len + 1) if code_lens is None else [int(c) for c in code_lens]):
        combos.setdefault((next_bucket(cl, 64, 64), next_bucket(int(cl * 1.72), 128, 128)), cl)
    lat_buckets = sorted({min(next_bucket(b, 64, 64), mt) for b in text_buckets})
    code_buckets = sorted({cb for cb, _ in combos})
    return PrecompileGrid(
        text_buckets, [(tb, cb) for tb in lat_buckets for cb in code_buckets],
        [(cb, tb, cl) for (cb, tb), cl in sorted(combos.items())],
        sorted({tb for _, tb in combos}))


def load_model(name: str, cfg: IndexTTS2Config, state_dict: Dict[str, torch.Tensor],
               device: torch.device) -> torch.nn.Module:
    """Build model `name` without initializing it and adopt `state_dict`
    (moved to `device`) as its parameters; eval mode, no gradients."""
    with torch.device("meta"):
        m = MODELS[name](cfg, device)
    sd = {k: v.to(device) for k, v in state_dict.items()}
    m.load_state_dict(sd, strict=True, assign=True)
    return m.eval().requires_grad_(False)


def evict_one(cache: Dict) -> None:
    """Drop the oldest entry of a bounded cache (tolerates concurrent use)."""
    try:
        cache.pop(next(iter(cache)), None)
    except (StopIteration, RuntimeError):
        pass


@dataclass
class SpeakerConditioning:
    spk_cond_emb: torch.Tensor  # (1, Tc, 1024) w2v-BERT features
    cond_len: int
    style: torch.Tensor  # (1, 192)
    prompt_condition: torch.Tensor  # (1, P, 512)
    ref_mel: torch.Tensor  # (1, 80, P)
    ref_mel_len: int
    spk_latents: torch.Tensor  # (1, 32, D)


@dataclass
class EmotionConditioning:
    emo_cond_emb: torch.Tensor
    cond_len: int


@dataclass
class SegmentResult:
    wav: np.ndarray  # (T,) float32 at 22.05 kHz
    codes_len: int
    gpt_gen_time: float
    gpt_forward_time: float
    s2mel_time: float
    bigvgan_time: float


def head_quant(cfg: IndexTTS2Config) -> bool:
    """The int8 logits head needs the quantized GPT, as in the JAX engine."""
    return cfg.runtime.head_quant and cfg.runtime.gpt_quantize


def resolve_gemv(cfg: IndexTTS2Config, device) -> bool:
    """Do the quantized GPT's single-token decode calls take the kernels of
    ops/gemv.py? The JAX engine's resolution of `gemv_impl`
    (indextts_tpu/runtime/engine.py:117-138), with the card in the TPU's
    place: "pallas" takes them; "auto" takes them for W4 on CUDA, where the
    packed weights pay only through the kernels, and leaves W8 and every
    other device on the plain contraction; anything else does not."""
    rt = cfg.runtime
    if rt.gemv_impl == "auto":
        wbits = rt.gpt_wbits if rt.gpt_quantize else 8
        return wbits == 4 and torch.device(device).type == "cuda"
    return rt.gemv_impl == "pallas"


def kv_int8(cfg: IndexTTS2Config) -> bool:
    """An int8 KV cache: kv_quant, or the JAX package's pallas_q8 route."""
    return cfg.runtime.kv_quant or cfg.runtime.attn_impl == "pallas_q8"


def _float_gpt(cfg: IndexTTS2Config) -> IndexTTS2Config:
    rt = dataclasses.replace(cfg.runtime, gpt_quantize=False, head_quant=False)
    return dataclasses.replace(cfg, runtime=rt)


def _check_supported(cfg: IndexTTS2Config) -> None:
    rt = cfg.runtime
    if rt.gpt_quantize and rt.gpt_wbits not in (8, 4):
        raise ValueError(f"runtime.gpt_wbits={rt.gpt_wbits}: quantized GPT weights "
                         "have 8 or 4 bits")
    for name in ("s2mel_dtype", "voc_dtype"):
        if getattr(rt, name) != "float32":
            raise NotImplementedError(f"runtime.{name}={getattr(rt, name)!r}: "
                                      "only float32 is ported")


def random_params(cfg: IndexTTS2Config, seed: int = 0, device=None) -> Dict[str, Dict]:
    """Random float state dicts for every model, drawn on `device` from
    `seed`: each module's own PyTorch initialization (zero-mean, fan-in
    scaled), which keeps activations bounded at any width. The JAX package's
    U[0.01, 0.05) fill does not: its all-positive weights grow through the
    vocoder's convolutions until, at full width, float32 overflows and the
    waveform is NaN. A quantized GPT starts from the same float weights: the
    engine quantizes them."""
    dev = resolve_device(device)
    cfg = _float_gpt(cfg)
    out = {}
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        for name, ctor in MODELS.items():
            with torch.device(dev):
                out[name] = dict(ctor(cfg, dev).state_dict())
    return out


class IndexTTS2Engine:
    def __init__(
        self,
        cfg: IndexTTS2Config,
        params: Dict[str, Dict[str, torch.Tensor]],
        device=None,
        semantic_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        tokenizer=None,
        precise_shapes: bool = False,
    ):
        """params: {"gpt", "s2mel", "bigvgan", "repcodec", "campplus",
        "w2vbert"} state dicts (weights.from_jax_params or random_params).
        With runtime.gpt_quantize, a float GPT state dict is quantized here
        (the JAX engine's quantize_gpt_tree step). precise_shapes: solve
        the CFM at the exact target length, not its 128-frame bucket (the
        JAX engine's parity mode)."""
        _check_supported(cfg)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.precise = precise_shapes
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = dict(params)
        gpt_sd = params["gpt"]
        if cfg.runtime.gpt_quantize and "gpt.h.0.attn.c_attn.weight" in gpt_sd:
            params["gpt"] = quantize_gpt_state_dict(gpt_sd, head=head_quant(cfg),
                                                    bits=cfg.runtime.gpt_wbits)
        mods = {name: load_model(name, cfg, params[name], self.device) for name in MODELS}
        self.gpt: UnifiedVoice = mods["gpt"]
        self.s2mel: S2Mel = mods["s2mel"]
        self.bigvgan: BigVGAN = mods["bigvgan"]
        self.repcodec: RepCodec = mods["repcodec"]
        self.campplus: CAMPPlus = mods["campplus"]
        self.w2vbert: W2VBertEncoder = mods["w2vbert"]

        hs = cfg.w2vbert.hidden_size
        mean, std = semantic_stats if semantic_stats is not None else (
            np.zeros(hs, np.float32), np.ones(hs, np.float32))
        self.semantic_mean = torch.as_tensor(np.asarray(mean, np.float32), device=self.device)
        self.semantic_std = torch.as_tensor(np.asarray(std, np.float32), device=self.device)

        rt = cfg.runtime
        self.decoder = GPTDecoder(self.gpt, cfg.gpt,
                                  SamplingConfig(do_sample=rt.do_sample, top_k=rt.top_k),
                                  kv_int8=kv_int8(cfg))
        self.latent_runner = LatentRunner(self.gpt)
        self.s2mel_runner = S2MelRunner(self.s2mel, rt.diffusion_steps, rt.cfg_rate)
        self.vocoder_runner = VocoderRunner(self.bigvgan, rt.device_pcm16)
        self._spk_cache: Dict[str, SpeakerConditioning] = {}
        self._emo_cache: Dict[str, EmotionConditioning] = {}
        # seeds for seedless requests (serving threads share the engine)
        self._seed_gen = np.random.default_rng()
        self._seed_lock = threading.Lock()
        # test hooks: CFM noise injection and mel capture
        self._noise_hook: Optional[Callable[[tuple], np.ndarray]] = None
        self._mel_taps: Optional[List[np.ndarray]] = None

    def _stage_barrier(self) -> None:
        """Under TARS_STAGE_SYNC=1, wait for the card to finish this
        thread's stream's work, so that the stage's clock holds it."""
        if self.device.type == "cuda" and os.environ.get("TARS_STAGE_SYNC", "0") == "1":
            torch.cuda.current_stream(self.device).synchronize()

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _seed(self, seed: Optional[int]) -> int:
        """`seed`, or a fresh random one for a seedless request."""
        if seed is None:
            with self._seed_lock:
                seed = int(self._seed_gen.integers(0, 2**62))
        return seed

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self._seed(seed))

    # -- conditioning (infer_v2.py:618-666) --------------------------------

    def _w2v(self, audio_16k: np.ndarray) -> Tuple[torch.Tensor, int]:
        features, mask = feat.seamless_features(audio_16k)
        h = self.w2vbert(self._tensor(features), self._tensor(mask))
        return (h - self.semantic_mean) / self.semantic_std, int(mask.sum())

    @torch.inference_mode()
    def prepare_speaker(self, audio: np.ndarray, sr: int,
                        cache_key: Optional[str] = None) -> SpeakerConditioning:
        if cache_key is not None and cache_key in self._spk_cache:
            return self._spk_cache[cache_key]
        audio = audio[: 15 * sr]
        audio_16k = audio_utils.resample(audio, sr, 16000)
        audio_22k = audio_utils.resample(audio, sr, 22050)
        cond_emb, cond_len = self._w2v(audio_16k)
        _, s_ref = self.repcodec.quantize(cond_emb)
        ref_mel = mel_ops.mel_spectrogram(
            self._tensor(audio_22k[None], torch.float32), self.cfg.s2mel.mel)
        ref_mel_len = ref_mel.shape[2]
        fb = feat.campplus_fbank(audio_16k)
        fb = fb - fb.mean(axis=0, keepdims=True)
        style = self.campplus(self._tensor(fb[None], torch.float32))
        prompt_condition = self.s2mel.regulate(
            s_ref, self._tensor([ref_mel_len]), ref_mel_len)
        spk_latents = self.gpt.get_conditioning(cond_emb, self._tensor([cond_len]))
        out = SpeakerConditioning(cond_emb, cond_len, style, prompt_condition,
                                  ref_mel, ref_mel_len, spk_latents)
        if cache_key is not None:
            if len(self._spk_cache) >= 8:
                evict_one(self._spk_cache)
            self._spk_cache[cache_key] = out
        return out

    @torch.inference_mode()
    def prepare_emotion(self, audio: np.ndarray, sr: int,
                        cache_key: Optional[str] = None) -> EmotionConditioning:
        if cache_key is not None and cache_key in self._emo_cache:
            return self._emo_cache[cache_key]
        cond_emb, cond_len = self._w2v(audio_utils.resample(audio[: 15 * sr], sr, 16000))
        out = EmotionConditioning(cond_emb, cond_len)
        if cache_key is not None:
            if len(self._emo_cache) >= 8:
                evict_one(self._emo_cache)
            self._emo_cache[cache_key] = out
        return out

    # -- synthesis ----------------------------------------------------------

    def synthesize_segment(self, spk: SpeakerConditioning, emo: EmotionConditioning,
                           text_ids: np.ndarray, seed: Optional[int] = None,
                           **gen_kwargs) -> SegmentResult:
        emovec, codes, t_gen = self._decode_segment_codes(
            spk, emo, text_ids, seed=seed, **gen_kwargs)
        return self._finish_from_codes(spk, emovec, text_ids, codes, seed, t_gen)

    @torch.inference_mode()
    def segment_conds(self, spk: SpeakerConditioning, emo: EmotionConditioning,
                      emo_alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """A segment's conditioning: (emovec (1, D), the GPT prompt's
        conditioning latents (1, 34, D)), merge_emovec then
        build_conds_latent."""
        emovec = self.gpt.merge_emovec(
            spk.spk_cond_emb, emo.emo_cond_emb, self._tensor([spk.cond_len]),
            self._tensor([emo.cond_len]), emo_alpha)
        return emovec, self.gpt.build_conds_latent(spk.spk_latents, emovec)

    @torch.inference_mode()
    def _decode_segment_codes(
        self,
        spk: SpeakerConditioning,
        emo: EmotionConditioning,
        text_ids: np.ndarray,
        emo_alpha: float = 1.0,
        max_mel_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        seed: Optional[int] = None,
        num_beams: Optional[int] = None,
        do_sample: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, np.ndarray, float]:
        """Conditioning merge + AR decode, ending at the host-side trimmed
        code row. Returns (emovec, codes, decode seconds)."""
        rt = self.cfg.runtime
        nb = num_beams if num_beams is not None else rt.num_beams
        if nb > 1:
            raise NotImplementedError("beam search (num_beams > 1) is not ported yet")
        t0 = time.perf_counter()
        emovec, conds = self.segment_conds(spk, emo, emo_alpha)
        n = len(text_ids)
        ids, pos, valid = self.decoder.build_text_prompt_arrays(
            np.asarray(text_ids)[None], np.asarray([n]), n)
        res = self.decoder.generate(
            conds, self._tensor(ids), self._tensor(pos), self._tensor(valid),
            self._seed(seed),
            max_new=max_mel_tokens or rt.max_mel_tokens,
            temperature=temperature if temperature is not None else rt.temperature,
            top_p=top_p if top_p is not None else rt.top_p,
            repetition_penalty_value=rt.repetition_penalty,
            do_sample=do_sample,
        )
        n_codes = int(res.lengths[0])
        codes = res.codes[0, :n_codes].cpu().numpy()
        return emovec, codes, time.perf_counter() - t0

    @staticmethod
    def remove_long_silence(codes: np.ndarray, stop_token: int, silent_token: int = 52,
                            max_consecutive: int = 30, compress: bool = True
                            ) -> Tuple[np.ndarray, int]:
        """Trim at the first stop token; with compress, cap runs of the silent
        token at 10 when the row holds more than max_consecutive of them."""
        stop_idx = np.nonzero(codes == stop_token)[0]
        length = int(stop_idx[0]) if len(stop_idx) else len(codes)
        code = codes[:length]
        if compress and int(np.sum(code == silent_token)) > max_consecutive:
            keep, run = [], 0
            for k in range(length):
                if code[k] != silent_token:
                    keep.append(k)
                    run = 0
                elif run < 10:
                    keep.append(k)
                    run += 1
            code = code[keep]
        return code, len(code)

    @torch.inference_mode()
    def _finish_from_codes(self, spk: SpeakerConditioning, emovec, text_ids: np.ndarray,
                           codes_trimmed: np.ndarray, seed: Optional[int],
                           t_gpt_gen: float) -> SegmentResult:
        """Latent pass + s2mel + vocoder for one decoded segment, each at its
        bucket (indextts_tpu/runtime/engine.py:724-827) unless precise."""
        cfg, rt, dev = self.cfg, self.cfg.runtime, self.device
        codes_row, code_len = self.remove_long_silence(
            codes_trimmed, cfg.gpt.stop_mel_token, compress=rt.remove_long_silence)
        code_len = max(code_len, 1)

        t1 = time.perf_counter()
        latent, codes_t = self._latent_pass(spk, emovec, np.asarray(text_ids), codes_row,
                                            code_len)
        self._stage_barrier()
        t_gpt_fwd = time.perf_counter() - t1

        t2 = time.perf_counter()
        exact_len = int(code_len * 1.72)
        bucket_len = next_bucket(exact_len, 128, 128)
        target_len = exact_len if self.precise else bucket_len
        shape = (1, cfg.s2mel.dit.in_channels, spk.ref_mel_len + target_len)
        if self._noise_hook is not None:
            noise = self._tensor(self._noise_hook(shape), torch.float32)
        else:
            # drawn at the bucket's width in both modes, then cut: each frame
            # gets the same noise, bucketed or exact
            noise = torch.randn(
                (1, shape[1], spk.ref_mel_len + bucket_len), device=dev,
                generator=self._generator(None if seed is None else seed + 1)
            )[:, :, :shape[2]]
        vc = self._s2mel_mel(spk, latent, codes_t, code_len, target_len, noise)
        mel_out = vc[:, :, spk.ref_mel_len:spk.ref_mel_len + exact_len]
        if self._mel_taps is not None:
            self._mel_taps.append(mel_out.cpu().numpy())
        self._stage_barrier()
        t_s2mel = time.perf_counter() - t2

        t3 = time.perf_counter()
        wav = self._vocode(mel_out, target_len)
        t_voc = time.perf_counter() - t3
        return SegmentResult(wav, code_len, t_gpt_gen, t_gpt_fwd, t_s2mel, t_voc)

    @torch.inference_mode()
    def _latent_pass(self, spk: SpeakerConditioning, emovec, text_ids: np.ndarray,
                     codes_row: np.ndarray, code_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced latent pass of `code_len` codes (the first of
        `codes_row`, stop tokens past them) after `text_ids`: the codes
        padded with the stop token to a multiple of 64, the text with zeros
        to a multiple of 64 capped at max_text_tokens (the padding masked
        inside forward_latent), exact with precise_shapes. Returns the latent
        (1, code width, D) and the padded codes (1, code width) on the
        device."""
        cfg = self.cfg
        n = len(text_ids)
        code_bucket = code_len if self.precise else next_bucket(code_len, 64, 64)
        text_bucket = n if self.precise else min(next_bucket(n, 64, 64),
                                                 cfg.gpt.max_text_tokens)
        codes_arr = np.full((1, code_bucket), cfg.gpt.stop_mel_token, np.int64)
        n_copy = min(code_len, len(codes_row))
        codes_arr[0, :n_copy] = codes_row[:n_copy]
        text_arr = np.zeros((1, text_bucket), np.int64)
        text_arr[0, :n] = text_ids[:n]
        codes_t = self._tensor(codes_arr)
        latent = self.latent_runner.latent(
            spk.spk_latents, self._tensor(text_arr), self._tensor([n]), codes_t,
            self._tensor([code_len]), emovec)
        return latent, codes_t

    @torch.inference_mode()
    def _s2mel_mel(self, spk: SpeakerConditioning, latent, codes_t, code_len: int,
                   target_len: int, noise) -> torch.Tensor:
        """gpt_layer + vq2emb over the latent's and codes' width, the length
        regulator over the `code_len` valid codes to `target_len` frames
        (int(code_len * 1.72) of them valid), then the CFM solve: the mel
        (1, 80, prompt frames + target_len)."""
        cfg = self.cfg
        # the regulator's valid length is rounded in float32, as in the JAX engine
        ylen = int(np.floor(np.float32(code_len) * np.float32(1.72)))
        code_len_t, ylens = self._tensor([code_len]), self._tensor([ylen])
        # the stop token that pads the codes to their bucket lies past the
        # codebook; the regulator reads no row at or past code_len, so those
        # rows are looked up clamped (the JAX engine's take fills them with NaN)
        codes_t = codes_t.clamp(max=cfg.semantic_codec.codebook_size - 1)
        s_infer = self.repcodec.vq2emb(codes_t) + self.s2mel.project_gpt_latent(latent)
        cond = self.s2mel.regulate(s_infer, ylens, target_len, code_len_t)
        cat_cond = torch.cat([spk.prompt_condition, cond], dim=1)
        total_len = spk.ref_mel_len + target_len
        prompt_x = torch.zeros((1, cfg.s2mel.dit.in_channels, total_len), device=self.device)
        prompt_x[:, :, :spk.ref_mel_len] = spk.ref_mel
        return self.s2mel_runner.solve(cat_cond, spk.ref_mel_len + ylens, prompt_x,
                                       spk.ref_mel_len, spk.style, noise)

    @torch.inference_mode()
    def _vocode(self, mel, target_len: int) -> np.ndarray:
        """BigVGAN over `mel` (1, 80, T) padded to `target_len` frames with
        log(1e-5) (silence), the PCM16 clip on the card under device_pcm16;
        the waveform cut to T frames' samples, float32 on the host."""
        pad = target_len - mel.shape[2]
        exact = mel.shape[2] * self.cfg.vocoder.total_upsample
        if pad:
            mel = torch.nn.functional.pad(mel, (0, pad), value=float(np.log(1e-5)))
        wav = self.vocoder_runner.vocode(mel)[0, :exact].cpu().numpy()
        if self.cfg.runtime.device_pcm16:
            return wav.astype(np.float32) / 32767.0
        return wav.astype(np.float32)

    def precompile(
        self,
        spk: SpeakerConditioning,
        emo: Optional[EmotionConditioning] = None,
        *,
        text_buckets: Optional[Sequence[int]] = None,
        max_code_len: int = 512,
        max_new: Optional[int] = None,
        num_beams: Optional[int] = None,
        do_sample: Optional[bool] = None,
        workers: int = 4,
        block: bool = True,
        code_lens: Optional[Sequence[int]] = None,
        decode_variants: str = "both",
    ) -> int:
        """Capture the serving envelope's programs before traffic comes: the
        JAX engine's `precompile` (indextts_tpu/runtime/engine.py:1006-1192)
        over the same grid (`precompile_grid`), in `workers` threads, each
        job one call of the stage through the engine's own code. Decode: one
        `generate` a text bucket, which captures the step of its (1, cap)
        state; the port has no cond-KV reuse, so "both" and "keyed" run the
        raw route, as the JAX engine's "keyed" falls back; "none" skips
        decode (continuous serving decodes in its own batcher). Latent: one
        pass a (text bucket, code bucket); s2mel: one stage a reachable
        (code bucket, target bucket), its solve keyed on the prompt's frames
        + the target bucket; vocoder: one call a target bucket. Captures
        take turns (`cuda_lib.capture`); the eager warm-ups before them may
        overlap. On the CPU nothing is captured, and no job runs. With
        `block=False` the jobs go on in the background. Returns the number
        of jobs."""
        rt, g = self.cfg.runtime, self.cfg.gpt
        if decode_variants not in ("both", "keyed", "raw", "none"):
            raise ValueError(f"decode_variants={decode_variants!r}: one of both, keyed, "
                             "raw, none")
        nb = rt.num_beams if num_beams is None else num_beams
        if nb > 1 and decode_variants != "none":
            raise NotImplementedError("beam search (num_beams > 1) is not ported yet")
        grid = precompile_grid(g.max_text_tokens, rt.max_text_tokens_per_segment,
                               text_buckets, max_code_len, code_lens)
        decode = [] if decode_variants == "none" else grid.text_buckets
        n_jobs = len(decode) + len(grid.latent) + len(grid.s2mel) + len(grid.vocoder)
        if self.device.type != "cuda":
            return n_jobs
        emo = emo if emo is not None else EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
        emovec, _ = self.segment_conds(spk, emo)
        # the request path's own calls, at each bucket's width
        jobs: List[Callable[[], Any]] = [
            functools.partial(self._decode_segment_codes, spk, emo, np.ones(b, np.int64),
                              max_mel_tokens=max_new, seed=0, do_sample=do_sample)
            for b in decode]
        stop, dev = g.stop_mel_token, self.device
        jobs += [functools.partial(self._latent_pass, spk, emovec, np.zeros(tb, np.int64),
                                   np.full(cb, stop, np.int64), cb)
                 for tb, cb in grid.latent]
        jobs += [functools.partial(
            self._s2mel_mel, spk, torch.zeros((1, cb, g.model_dim), device=dev),
            torch.full((1, cb), stop, device=dev), cl, tb,
            torch.zeros((1, self.cfg.s2mel.dit.in_channels, spk.ref_mel_len + tb), device=dev))
            for cb, tb, cl in grid.s2mel]
        jobs += [functools.partial(
            self._vocode, torch.full((1, self.cfg.s2mel.dit.in_channels, tb),
                                     float(np.log(1e-5)), device=dev), tb)
            for tb in grid.vocoder]
        pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                  thread_name_prefix="tars-precompile")
        futs = [pool.submit(j) for j in jobs]
        if block:
            for f in futs:
                f.result()
        pool.shutdown(wait=block)
        return n_jobs

    # -- request-level APIs ---------------------------------------------------

    def _conditioning(self, spk_audio, emo_audio, emo_alpha):
        """File paths are cache keys; (audio, sr) pairs are not cached. With
        no emotion prompt the speaker's features drive the emotion, alpha 1."""
        if isinstance(spk_audio, str):
            spk = self.prepare_speaker(*audio_utils.load_wav(spk_audio), cache_key=spk_audio)
        else:
            spk = self.prepare_speaker(*spk_audio)
        if emo_audio is None:
            return spk, EmotionConditioning(spk.spk_cond_emb, spk.cond_len), 1.0
        if isinstance(emo_audio, str):
            emo = self.prepare_emotion(*audio_utils.load_wav(emo_audio), cache_key=emo_audio)
        else:
            emo = self.prepare_emotion(*emo_audio)
        return spk, emo, emo_alpha

    def infer(
        self,
        spk_audio: Union[str, Tuple[np.ndarray, int]],
        text_ids_segments: List[np.ndarray],
        emo_audio: Optional[Union[str, Tuple[np.ndarray, int]]] = None,
        emo_alpha: float = 1.0,
        emo_vector: Optional[Sequence[float]] = None,
        interval_silence: int = 200,
        output_path: Optional[str] = None,
        seed: Optional[int] = None,
        batched: bool = False,
        **gen_kwargs: Any,
    ):
        """Sequential synthesis over pre-tokenized segments, in order.
        Returns {"sampling_rate", "audio", "duration_sec", "rtf", "stats"}."""
        if emo_vector is not None:
            raise NotImplementedError("emo_vector is not ported yet")
        if batched:
            raise NotImplementedError("batched segments are not ported yet")
        start = time.perf_counter()
        spk, emo, emo_alpha = self._conditioning(spk_audio, emo_audio, emo_alpha)
        stats = []
        for i, seg in enumerate(text_ids_segments):
            stats.append(self.synthesize_segment(
                spk, emo, np.asarray(seg), emo_alpha=emo_alpha,
                seed=None if seed is None else seed + i, **gen_kwargs))
        return self._joined(stats, start, interval_silence, output_path)

    def infer_continuous(
        self,
        service,
        spk_audio: Union[str, Tuple[np.ndarray, int]],
        text_ids_segments: List[np.ndarray],
        emo_audio: Optional[Union[str, Tuple[np.ndarray, int]]] = None,
        emo_alpha: float = 1.0,
        emo_vector: Optional[Sequence[float]] = None,
        interval_silence: int = 200,
        seed: Optional[int] = None,
        timeout: float = 600.0,
    ):
        """infer() through a shared runtime/batcher.py ContinuousService:
        the segments (and those of other concurrent requests) decode in one
        shared loop, segment i submitted with priority i and tail seed
        seed + i. Same return contract as infer()."""
        if emo_vector is not None:
            raise NotImplementedError("emo_vector is not ported yet")
        start = time.perf_counter()
        spk, emo, emo_alpha = self._conditioning(spk_audio, emo_audio, emo_alpha)
        futs = [service.submit(spk, emo, np.asarray(seg), emo_alpha=emo_alpha,
                               seed=None if seed is None else seed + i, priority=i)
                for i, seg in enumerate(text_ids_segments)]
        stats = [f.result(timeout=timeout) for f in futs]
        return self._joined(stats, start, interval_silence, None)

    def _joined(self, stats: List[SegmentResult], start: float, interval_silence: int,
                output_path: Optional[str]):
        """The segments' audio joined by interval_silence ms of silence, as
        infer() returns it."""
        sr_out = self.cfg.runtime.sampling_rate
        sil = np.zeros(int(sr_out * interval_silence / 1000.0), np.float32)
        pieces = []
        for i, r in enumerate(stats):
            pieces.append(r.wav)
            if i < len(stats) - 1:
                pieces.append(sil)
        wav = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        total = time.perf_counter() - start
        dur = len(wav) / sr_out
        if output_path:
            audio_utils.save_wav(output_path, wav, sr_out)
        return {"sampling_rate": sr_out, "audio": wav, "duration_sec": dur,
                "rtf": total / dur if dur > 0 else float("inf"), "stats": stats}

    def infer_text(self, spk_audio, text: str, use_emo_text: bool = False,
                   max_text_tokens_per_segment: Optional[int] = None, **kwargs):
        """Normalize + tokenize + split, then infer (needs a tokenizer)."""
        if use_emo_text:
            raise NotImplementedError("use_emo_text is not ported yet")
        return self.infer(spk_audio, self.text_segments(text, max_text_tokens_per_segment),
                          **kwargs)

    def text_segments(self, text: str, max_text_tokens_per_segment: Optional[int] = None
                      ) -> List[np.ndarray]:
        """Normalize + tokenize + split into segments of token ids."""
        if self.tokenizer is None:
            raise ValueError("engine has no tokenizer; pass pre-tokenized segments to infer()")
        max_seg = max_text_tokens_per_segment or self.cfg.runtime.max_text_tokens_per_segment
        segments = self.tokenizer.split_segments(self.tokenizer.tokenize(text), max_seg)
        return [np.asarray(self.tokenizer.convert_tokens_to_ids(s), np.int32)
                for s in segments]

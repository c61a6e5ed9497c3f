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

Fixed-speaker serving follows the JAX engine (indextts_tpu/runtime/
engine.py:580-661, 1300-1588). When both conditionings are file paths,
`infer` and `infer_generator` build a key (speaker path, emotion path or
"", alpha, the emotion vector as a tuple or None); under it a segment
takes (emovec, conds) from `_emoconds_cache` and, where the decoder's layout allows it
(`GPTDecoder.supports_cond_kv`), the conditioning prefix's KV from
`_cond_kv_cache`, and prefills only the text tail on top of it. Each cache
holds 8 keys. With `runtime.text_prefix_reuse` (TARS_PREFIX_REUSE, off by
default) a keyed segment's prompt is built left-aligned and its prefix is
looked up in `_text_prefix_cache` first (`_lookup_text_prefix`, JAX
indextts_tpu/runtime/engine.py:1189-1225): the float KV of
[conds][start_text][text[:m]] for the longest m on a grid of
TEXT_PREFIX_GRAN tokens that an earlier segment of the key cached, 8
entries at most; a miss prefills and caches the longest grid prefix of
this text. The batched and continuous routes do not reuse, as in JAX.
A request of several segments runs through `_pipelined_segments`
(`runtime.seq_tail_overlap`, off under TARS_STAGE_SYNC=1): a producer
thread decodes segment k+1 while one tail worker finishes segment k;
results come out in segment order, and a segment's seed gives the same
waveform on either route. `infer_generator`
streams each segment's waveform and the silence after it;
`infer_generator_continuous` streams through a ContinuousService.

The emotion controls follow the JAX engine (indextts_tpu/runtime/engine.py:
490-520, 598-612, 1227-1273). An `emo_vector` (8 weights) picks a row of
each emotion bank (`emo_matrix`, rows of the GPT's width, split by
`cfg.emo_num`): the row whose speaker-bank row is closest in cosine to the
prompt's CAMPPlus style, or a random one under `use_random`; their
weighted sum is blended with merge_emovec's output as `rows + (1 -
sum(emo_vector)) * emovec` before build_conds_latent, and the tail's
latent pass gets the blended emovec too. A vector overrides `emo_audio`
and sets alpha to 1; a `use_random` request has no key. `infer_text`
with `use_emo_text` asks the attached `qwen_emo` (runtime/qwen_emo.py)
for the vector.

The AR decode is routed by num_beams as in the JAX engine (indextts_tpu/
runtime/engine.py:639-690): past one beam, `GPTDecoder.generate_beam`
(beam-multinomial with do_sample, the config's default of 3 beams, else
deterministic), its prompt's text padded to the JAX engine's 16-bucket;
one beam, the sampling loop. `length_penalty` (runtime.length_penalty by
default) reaches it through every entry point's keyword arguments.
`infer(..., batched=True)` with several segments runs them all at once,
as the JAX engine's `synthesize_segments_batched` (indextts_tpu/runtime/
engine.py:847-1004, 1570-1579): one decode of B rows with the decoder's
sampling, then one latent pass, one CFM solve and one vocoder call over
the B rows, each stage's graph keyed on B; one segment takes the
sequential route. `infer_continuous`
decodes the segments in a shared runtime/batcher.py ContinuousService,
with sampling only, as the JAX batcher does.

The AR decode (runtime/decode.py `GPTDecoder`) replays a captured step on
the card; the engine hands it each request's seed (a random one for a
seedless request), from which the decoder reseeds its own generator.

The compute dtypes follow the JAX engine's (indextts_tpu/runtime/engine.py:
95-226): `gpt_dtype` (float32 by default; the config's runtime.gpt_dtype
is not read, as the JAX engine does not read it), `cond_dtype` for
w2v-BERT (float32), runtime.s2mel_dtype for the regulator, gpt_layer and
DiT, and runtime.voc_dtype (or the `voc_dtype` argument) for BigVGAN; each
model's float weights are stored in its dtype (weights.py `put_as`: the
int8 layers' scales stay float32), RepCodec and CAMPPlus in float32.
Layers compute in the promoted dtype of input and weights, and a model
whose JAX counterpart has a `dtype` casts its input to it
(models/layers.py). A bfloat16 s2mel keeps the Euler state, the time
embedding, the norm statistics and the softmax in float32, and its mel
comes out float32. A bfloat16 vocoder is dual, as in the JAX engine: a
float32 sibling (`bigvgan_f32`, its own runner `vocoder_runner`) vocodes
the sequential, streaming and continuous routes and precompile's grid,
and the bfloat16 model (`bigvgan`, `batch_vocoder_runner`) only the
batched route, its waveform bfloat16 up to the PCM16 clip.

Runs on `cuda` unless the caller passes `device="cpu"`. The constructor
turns TF32 off for matmuls and cuDNN convolutions, which PyTorch would
otherwise use for float32 convolutions on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import queue
import threading
import time
from dataclasses import dataclass
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

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
from indextts_tpu_torch.weights import put_as, quantize_gpt_state_dict

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
               device: torch.device, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """Build model `name` without initializing it and adopt `state_dict`,
    stored in `dtype` (`put_as`, cast before the move) and moved to
    `device`, as its parameters; eval mode, no gradients."""
    with torch.device("meta"):
        m = MODELS[name](cfg, device)
    return adopt(m, state_dict, device, dtype)


def adopt(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor], device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """`model` (built on the meta device) with `state_dict`, stored in
    `dtype` (`put_as`, cast before the move) and moved to `device`, as its
    parameters; eval mode, no gradients."""
    sd = {k: v.to(device) for k, v in put_as(state_dict, dtype).items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)


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
    return gemv_route(rt.gemv_impl, rt.gpt_wbits if rt.gpt_quantize else 8, device)


def gemv_route(gemv_impl: str, wbits: int, device) -> bool:
    """`resolve_gemv` of the knob `gemv_impl` for `wbits`-bit weights."""
    if gemv_impl == "auto":
        return wbits == 4 and torch.device(device).type == "cuda"
    return gemv_impl == "pallas"


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


def config_dtype(name: str) -> torch.dtype:
    """A runtime dtype setting ("bfloat16" or anything else) as the JAX
    engine resolves it: bfloat16, else float32."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _compute_dtype(dtype, what: str) -> torch.dtype:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}={dtype}: float32 or bfloat16")
    return dtype


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
        emo_matrix: Optional[np.ndarray] = None,
        spk_matrix: Optional[np.ndarray] = None,
        gpt_dtype: torch.dtype = torch.float32,
        voc_dtype: Optional[torch.dtype] = None,
        cond_dtype: torch.dtype = torch.float32,
    ):
        """params: {"gpt", "s2mel", "bigvgan", "repcodec", "campplus",
        "w2vbert"} state dicts (weights.from_jax_params or random_params).
        gpt_dtype, cond_dtype: the GPT's and w2v-BERT's compute dtypes;
        voc_dtype: BigVGAN's, None for runtime.voc_dtype (the JAX engine's
        arguments and defaults).
        With runtime.gpt_quantize, a float GPT state dict is quantized here
        (the JAX engine's quantize_gpt_tree step). precise_shapes: solve
        the CFM at the exact target length, not its 128-frame bucket (the
        JAX engine's parity mode). emo_matrix / spk_matrix: the emotion
        banks (sum(emo_num), gpt.model_dim) and their speaker rows (...,
        192) (the reference's feat2.pt / feat1.pt), zeros by default."""
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
        if voc_dtype is None:
            voc_dtype = config_dtype(cfg.runtime.voc_dtype)
        self.s2mel_dtype = config_dtype(cfg.runtime.s2mel_dtype)
        dtypes = {"gpt": _compute_dtype(gpt_dtype, "gpt_dtype"), "s2mel": self.s2mel_dtype,
                  "bigvgan": _compute_dtype(voc_dtype, "voc_dtype"),
                  "w2vbert": _compute_dtype(cond_dtype, "cond_dtype")}
        mods = {name: load_model(name, cfg, params[name], self.device,
                                 dtypes.get(name, torch.float32)) for name in MODELS}
        self.gpt: UnifiedVoice = mods["gpt"]
        self.s2mel: S2Mel = mods["s2mel"]
        self.bigvgan: BigVGAN = mods["bigvgan"]
        # the float32 vocoder that serves one row (the JAX engine's
        # bigvgan_f32): a second model beside a bfloat16 one
        self.bigvgan_f32: BigVGAN = (self.bigvgan if voc_dtype == torch.float32 else
                                     load_model("bigvgan", cfg, params["bigvgan"], self.device))
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
                                  kv_int8=kv_int8(cfg), attn_impl=rt.attn_impl)
        self.latent_runner = LatentRunner(self.gpt)
        self.s2mel_runner = S2MelRunner(self.s2mel, rt.diffusion_steps, rt.cfg_rate)
        self.vocoder_runner = VocoderRunner(self.bigvgan_f32, rt.device_pcm16)
        # the batched route's runner: the voc_dtype model's
        self.batch_vocoder_runner = (self.vocoder_runner if self.bigvgan is self.bigvgan_f32
                                     else VocoderRunner(self.bigvgan, rt.device_pcm16))
        self._spk_cache: Dict[str, SpeakerConditioning] = {}
        self._emo_cache: Dict[str, EmotionConditioning] = {}
        # per conditioning key: ((emovec, conds), ready) and (prefix KV,
        # ready), `ready` the event after the work that made the value
        # (None on the CPU); one lock covers a lookup, its miss and insert
        self._emoconds_cache: Dict[tuple, tuple] = {}
        self._cond_kv_cache: Dict[tuple, tuple] = {}
        # per (key, m, sha256 of text[:m]): (text-prefix KV, ready)
        self._text_prefix_cache: Dict[tuple, tuple] = {}
        self._keyed_lock = threading.Lock()
        # seeds for seedless requests (serving threads share the engine)
        self._seed_gen = np.random.default_rng()
        self._seed_lock = threading.Lock()
        # the emotion banks, one tensor a bank; use_random's row draws

        def bank(m, width: int) -> List[torch.Tensor]:
            m = np.zeros((sum(cfg.emo_num), width)) if m is None else m
            return list(torch.split(self._tensor(np.asarray(m, np.float32)),
                                    list(cfg.emo_num)))

        self.emo_matrix = bank(emo_matrix, cfg.gpt.model_dim)
        self.spk_matrix = bank(spk_matrix, 192)
        self._bank_draws = torch.Generator()
        self._bank_lock = threading.Lock()
        # the text-to-emotion model (runtime/qwen_emo.py QwenEmotion) that
        # infer_text's use_emo_text asks; none until a caller attaches one
        self.qwen_emo = None
        # runtime/loader.py load_engine's LoadReport, for an engine it built
        self.load_report = None
        # test hooks: CFM noise injection and mel capture
        self._noise_hook: Optional[Callable[[tuple], np.ndarray]] = None
        self._mel_taps: Optional[List[np.ndarray]] = None

    def _stage_barrier(self) -> None:
        """Under TARS_STAGE_SYNC=1, wait for the card to finish this
        thread's stream's work, so that the stage's clock holds it."""
        if self.device.type == "cuda" and os.environ.get("TARS_STAGE_SYNC", "0") == "1":
            torch.cuda.current_stream(self.device).synchronize()

    def _mark(self) -> Optional[torch.cuda.Event]:
        """An event after the work queued so far on this thread's stream
        (None on the CPU): what a reader on another stream waits for."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _after(self, ev: Optional[torch.cuda.Event]) -> None:
        """Order this thread's stream after `ev` (`_mark`)."""
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

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
                           cond_kv_key: Optional[tuple] = None,
                           **gen_kwargs) -> SegmentResult:
        emovec, codes, t_gen = self._decode_segment_codes(
            spk, emo, text_ids, seed=seed, cond_kv_key=cond_kv_key, **gen_kwargs)
        return self._finish_from_codes(spk, emovec, text_ids, codes, seed, t_gen)

    @torch.inference_mode()
    def _emovec_from_matrix(self, emo_vector: Sequence[float], style: torch.Tensor,
                            use_random: bool, seed: Optional[int] = None) -> torch.Tensor:
        """The emotion banks' rows weighted by emo_vector and summed, (1, D):
        from each bank the row whose speaker row has the highest cosine
        similarity with `style` (1, 192), the first of equal ones as
        numpy's argmax, on the device (indextts_tpu/runtime/engine.py:
        490-507); under use_random a row drawn from the engine's generator,
        reseeded with `seed` when one is given."""
        if use_random:
            with self._bank_lock:
                if seed is not None:
                    self._bank_draws.manual_seed(seed)
                idx = [torch.randint(len(m), (1,), generator=self._bank_draws)
                       for m in self.emo_matrix]
        else:
            s = style[0]
            idx = [torch.argmax((spk_m @ s) / (spk_m.norm(dim=1) * s.norm() + 1e-8)).view(1)
                   for spk_m in self.spk_matrix]
        rows = torch.cat([m.index_select(0, i.to(m.device))
                          for m, i in zip(self.emo_matrix, idx)])
        weights = self._tensor(np.asarray(emo_vector, np.float32))
        return (weights[:, None] * rows).sum(0)[None]

    @staticmethod
    def normalize_emo_vec(emo_vector: Sequence[float], apply_bias: bool = True) -> List[float]:
        """Each weight times its emotion's bias, then the whole scaled down
        to a sum of 0.8 when it is larger (infer_v2.py:524-538; the CLI's
        --emo-vector)."""
        v = list(emo_vector)
        if apply_bias:
            bias = [0.9375, 0.875, 1.0, 1.0, 0.9375, 0.9375, 0.6875, 0.5625]
            v = [x * b for x, b in zip(v, bias)]
        s = sum(v)
        if s > 0.8:
            v = [x * 0.8 / s for x in v]
        return v

    @torch.inference_mode()
    def segment_conds(self, spk: SpeakerConditioning, emo: EmotionConditioning,
                      emo_alpha: float = 1.0, emo_vector: Optional[Sequence[float]] = None,
                      use_random: bool = False, seed: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A segment's conditioning: (emovec (1, D), the GPT prompt's
        conditioning latents (1, 34, D)), merge_emovec, blended with the
        banks' rows when there is an emo_vector (indextts_tpu/runtime/
        engine.py:598-612), then build_conds_latent."""
        emovec = self.gpt.merge_emovec(
            spk.spk_cond_emb, emo.emo_cond_emb, self._tensor([spk.cond_len]),
            self._tensor([emo.cond_len]), emo_alpha)
        if emo_vector is not None:
            rows = self._emovec_from_matrix(emo_vector, spk.style, use_random, seed)
            emovec = rows + (1.0 - float(np.sum(emo_vector))) * emovec
        return emovec, self.gpt.build_conds_latent(spk.spk_latents, emovec)

    # text-prefix reuse's grid: prefixes are cached at multiples of this
    # many text ids (the JAX engine's)
    TEXT_PREFIX_GRAN = 32

    def _reuses_text(self, cond_kv_key: Optional[tuple]) -> bool:
        """Does a segment under `cond_kv_key` take text-prefix reuse, with
        its prompt left-aligned? The JAX rule (indextts_tpu/runtime/
        engine.py:624-629): the flag set, the request keyed and the
        decoder reusing a prefix."""
        return (self.cfg.runtime.text_prefix_reuse and cond_kv_key is not None
                and self.decoder.supports_cond_kv)

    def _lookup_text_prefix(self, cond_kv_key: tuple, conds, text_ids: np.ndarray):
        """The cached (text-prefix KV, ready) of the longest grid prefix of
        `text_ids` under `cond_kv_key`, keyed as the JAX engine keys it:
        (key, m, sha256 of text[:m] as int32). On a miss the longest grid
        prefix of this text is prefilled and cached (8 entries at most).
        None for a text shorter than the grid. Called under _keyed_lock."""
        g = self.TEXT_PREFIX_GRAN
        text = np.asarray(text_ids, np.int32)
        m_max = len(text) // g * g
        if m_max < g:
            return None
        keys = [(cond_kv_key, m, hashlib.sha256(text[:m].tobytes()).hexdigest())
                for m in range(m_max, g - 1, -g)]
        hit = next((self._text_prefix_cache[k] for k in keys if k in self._text_prefix_cache),
                   None)
        if hit is None:
            hit = (self.decoder.text_prefix_prefill(conds, text[:m_max]), self._mark())
            if len(self._text_prefix_cache) >= 8:
                evict_one(self._text_prefix_cache)
            self._text_prefix_cache[keys[0]] = hit
        return hit

    @torch.inference_mode()
    def _segment_inputs(self, spk: SpeakerConditioning, emo: EmotionConditioning,
                        emo_alpha: float, cond_kv_key: Optional[tuple],
                        emo_vector: Optional[Sequence[float]] = None,
                        use_random: bool = False, seed: Optional[int] = None,
                        text_ids: Optional[np.ndarray] = None):
        """(emovec, conds, prefix KV or None) for a segment. Without a key,
        `segment_conds` anew and no prefix KV. With one, the cached values
        of the key (indextts_tpu/runtime/engine.py:580-661), each made on a
        miss: (emovec, conds) always, and, where the decoder reuses a
        prefix, the KV of the text prefix of `text_ids` when they are given
        (text-prefix reuse, `_lookup_text_prefix`; the prompt must then be
        left-aligned), else of the conditioning prefix
        (`GPTDecoder.cond_prefill`). The current stream waits for the work
        that made them, which may have run on another thread's stream."""
        conds_args = (emo_alpha, emo_vector, use_random, seed)
        if cond_kv_key is None:
            return (*self.segment_conds(spk, emo, *conds_args), None)
        with self._keyed_lock:
            hit = self._emoconds_cache.get(cond_kv_key)
            if hit is None:
                hit = (self.segment_conds(spk, emo, *conds_args), self._mark())
                if len(self._emoconds_cache) >= 8:
                    evict_one(self._emoconds_cache)
                self._emoconds_cache[cond_kv_key] = hit
            (emovec, conds), ready = hit
            self._after(ready)
            kv_hit = None
            if text_ids is not None and self.decoder.supports_cond_kv:
                kv_hit = self._lookup_text_prefix(cond_kv_key, conds, text_ids)
            if kv_hit is None and self.decoder.supports_cond_kv:
                kv_hit = self._cond_kv_cache.get(cond_kv_key)
                if kv_hit is None:
                    kv_hit = (self.decoder.cond_prefill(conds), self._mark())
                    if len(self._cond_kv_cache) >= 8:
                        evict_one(self._cond_kv_cache)
                    self._cond_kv_cache[cond_kv_key] = kv_hit
            prefix, kv_ready = kv_hit or (None, None)
            self._after(kv_ready)
        return emovec, conds, prefix

    def _decode_segment_codes(
        self,
        spk: SpeakerConditioning,
        emo: EmotionConditioning,
        text_ids: np.ndarray,
        emo_alpha: float = 1.0,
        cond_kv_key: Optional[tuple] = None,
        emo_vector: Optional[Sequence[float]] = None,
        use_random: bool = False,
        seed: Optional[int] = None,
        **gen_kwargs,
    ) -> Tuple[torch.Tensor, np.ndarray, float]:
        """Conditioning (cached under `cond_kv_key`) + AR decode, ending at
        the host-side trimmed code row. Returns (emovec, codes, decode
        seconds). Whether the segment takes text-prefix reuse is decided
        here alone: its text prefix is looked up and its prompt
        left-aligned together."""
        t0 = time.perf_counter()
        reuse = self._reuses_text(cond_kv_key)
        emovec, conds, prefix = self._segment_inputs(spk, emo, emo_alpha, cond_kv_key,
                                                     emo_vector, use_random, seed,
                                                     text_ids if reuse else None)
        codes = self._generate_codes(conds, text_ids, prefix, seed=seed,
                                     align="left" if reuse else "right", **gen_kwargs)
        return emovec, codes, time.perf_counter() - t0

    @torch.inference_mode()
    def _generate_codes(
        self,
        conds: torch.Tensor,
        text_ids: np.ndarray,
        cond_kv=None,
        max_mel_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        seed: Optional[int] = None,
        num_beams: Optional[int] = None,
        do_sample: Optional[bool] = None,
        length_penalty: Optional[float] = None,
        align: str = "right",
    ) -> np.ndarray:
        """The AR decode of one segment from its conds (1, 34, D), on top of
        the prefix KV `cond_kv` when given, its prompt's text aligned by
        `align` (left under text-prefix reuse): the code row, stop token
        included, on the host. Routed by num_beams as the JAX engine
        (indextts_tpu/runtime/engine.py:615-690): beam search (multinomial
        with do_sample, else deterministic) past one beam, over the text
        padded to a 16-bucket (capped at max_text_tokens; exact when
        precise), so that S in its length normalization is the JAX
        engine's; else the sampling loop over the text at its exact
        width (the pads are masked, so its codes are the same)."""
        rt = self.cfg.runtime
        if cond_kv is not None and cond_kv[0].shape[3] > conds.shape[1] and align != "left":
            # the prefill drops the tail's first positions as the prefix's
            raise ValueError("a text-prefix KV needs a left-aligned prompt")
        nb = num_beams if num_beams is not None else rt.num_beams
        n = len(text_ids)
        bucket = n
        if nb > 1 and not self.precise:
            bucket = min(next_bucket(n, 16, 16), self.cfg.gpt.max_text_tokens)
        ids, pos, valid = self.decoder.build_text_prompt_arrays(
            np.asarray(text_ids)[None], np.asarray([n]), bucket, align)
        args = (conds, self._tensor(ids), self._tensor(pos), self._tensor(valid),
                self._seed(seed))
        kwargs = dict(max_new=max_mel_tokens or rt.max_mel_tokens,
                      temperature=temperature if temperature is not None else rt.temperature,
                      top_p=top_p if top_p is not None else rt.top_p,
                      repetition_penalty_value=rt.repetition_penalty, cond_kv=cond_kv)
        if nb > 1:
            res = self.decoder.generate_beam(
                *args, num_beams=nb, do_sample=do_sample if do_sample is not None else
                rt.do_sample, length_penalty=(length_penalty if length_penalty is not None
                                              else rt.length_penalty), **kwargs)
        else:
            res = self.decoder.generate(*args, do_sample=do_sample, **kwargs)
        n_codes = int(res.lengths[0])
        return res.codes[0, :n_codes].cpu().numpy()

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

    def _latent_pass(self, spk: SpeakerConditioning, emovec, text_ids: np.ndarray,
                     codes_row: np.ndarray, code_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced latent pass of `code_len` codes (the first of
        `codes_row`, stop tokens past them) after `text_ids`: `_latent_rows`
        of one row."""
        return self._latent_rows(spk, emovec, [np.asarray(text_ids)], [codes_row], [code_len])

    @torch.inference_mode()
    def _latent_rows(self, spk: SpeakerConditioning, emovec, texts: Sequence[np.ndarray],
                     code_rows: Sequence[np.ndarray], code_lens: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The teacher-forced latent pass of B rows, row b `code_lens[b]`
        codes (the first of `code_rows[b]`, stop tokens past them) after
        `texts[b]`, over one speaker's latents and one emovec (1, D): the
        codes padded with the stop token to a multiple of 64 of the longest,
        the texts with zeros to a multiple of 64 of the longest capped at
        max_text_tokens (the padding masked inside forward_latent), exact
        with precise_shapes. Returns the latent (B, code width, D) and the
        padded codes (B, code width) on the device."""
        cfg, B = self.cfg, len(texts)
        lens = [len(t) for t in texts]
        n, code_len = max(lens), max(code_lens)
        code_bucket = code_len if self.precise else next_bucket(code_len, 64, 64)
        text_bucket = n if self.precise else min(next_bucket(n, 64, 64),
                                                 cfg.gpt.max_text_tokens)
        codes_arr = np.full((B, code_bucket), cfg.gpt.stop_mel_token, np.int64)
        text_arr = np.zeros((B, text_bucket), np.int64)
        for b in range(B):
            n_copy = min(code_lens[b], len(code_rows[b]))  # 0: a stop-only row
            codes_arr[b, :n_copy] = code_rows[b][:n_copy]
            text_arr[b, :lens[b]] = texts[b]
        codes_t = self._tensor(codes_arr)
        latent = self.latent_runner.latent(
            spk.spk_latents.expand(B, -1, -1).contiguous(), self._tensor(text_arr),
            self._tensor(lens), codes_t, self._tensor(np.asarray(code_lens)),
            emovec.expand(B, -1).contiguous())
        return latent, codes_t

    @torch.inference_mode()
    def _s2mel_mel(self, spk: SpeakerConditioning, latent, codes_t, code_lens,
                   target_len: int, noise) -> torch.Tensor:
        """gpt_layer + vq2emb over the latent's and codes' width (B rows),
        the length regulator over each row's `code_lens` valid codes (an int
        for one row) to `target_len` frames (int(code_len * 1.72) of them
        valid), then the CFM solve over the speaker's prompt broadcast to
        the B rows, each row's valid frames its own (JAX `_s2mel_mel`,
        indextts_tpu/runtime/engine.py:339-400): the mel (B, 80, prompt
        frames + target_len), float32. The latent and the conditions enter
        the s2mel dtype as in the JAX engine: gpt_layer over the latent cast
        to it, its sum with vq2emb taken in float32 and cast."""
        cfg, dt = self.cfg, self.s2mel_dtype
        B = latent.shape[0]
        code_lens = np.atleast_1d(np.asarray(code_lens, np.int64))
        # the regulator's valid length is rounded in float32, as in the JAX engine
        ylens = self._tensor(np.floor(code_lens.astype(np.float32) * np.float32(1.72))
                             .astype(np.int64))
        # the stop token that pads the codes to their bucket lies past the
        # codebook; the regulator reads no row at or past code_len, so those
        # rows are looked up clamped (the JAX engine's take fills them with NaN)
        codes_t = codes_t.clamp(max=cfg.semantic_codec.codebook_size - 1)
        # in the s2mel dtype, the sum in float32 (the JAX engine's casts)
        s_infer = (self.repcodec.vq2emb(codes_t)
                   + self.s2mel.project_gpt_latent(latent.to(dt)).float()).to(dt)
        cond = self.s2mel.regulate(s_infer, ylens, target_len, self._tensor(code_lens))
        cat_cond = torch.cat([spk.prompt_condition.to(dt).expand(B, -1, -1), cond.to(dt)],
                             dim=1)
        total_len = spk.ref_mel_len + target_len
        prompt_x = torch.zeros((B, cfg.s2mel.dit.in_channels, total_len), device=self.device)
        prompt_x[:, :, :spk.ref_mel_len] = spk.ref_mel
        return self.s2mel_runner.solve(cat_cond, spk.ref_mel_len + ylens, prompt_x,
                                       spk.ref_mel_len, spk.style.expand(B, -1).contiguous(),
                                       noise)

    @torch.inference_mode()
    def _vocode(self, mel, target_len: int) -> np.ndarray:
        """BigVGAN over `mel` (1, 80, T) padded to `target_len` frames with
        log(1e-5) (silence): `_vocode_rows` of one row, cut to T frames."""
        pad = target_len - mel.shape[2]
        frames = mel.shape[2]
        if pad:
            mel = torch.nn.functional.pad(mel, (0, pad), value=float(np.log(1e-5)))
        return self._vocode_rows(mel, [frames])[0]

    @torch.inference_mode()
    def _vocode_rows(self, mel, frames: Sequence[int],
                     runner: Optional[VocoderRunner] = None) -> List[np.ndarray]:
        """BigVGAN over mels (B, 80, T) through `runner` (by default the
        float32 vocoder's), the PCM16 clip on the card under device_pcm16;
        row b's waveform cut to `frames[b]` frames' samples, float32 on the
        host."""
        up = self.cfg.vocoder.total_upsample
        wav = (runner or self.vocoder_runner).vocode(mel)[:, :max(frames) * up]
        if wav.dtype == torch.bfloat16:
            wav = wav.float()
        wav = wav.cpu().numpy()
        out = [wav[b, :f * up].astype(np.float32) for b, f in enumerate(frames)]
        if self.cfg.runtime.device_pcm16:
            return [w / 32767.0 for w in out]
        return out

    def synthesize_segments_batched(
        self,
        spk: SpeakerConditioning,
        emo: EmotionConditioning,
        segments: List[np.ndarray],
        emo_alpha: float = 1.0,
        emo_vector: Optional[Sequence[float]] = None,
        use_random: bool = False,
        max_mel_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        seed: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Every segment of one request at once (indextts_tpu/runtime/
        engine.py:847-1004): one decode of B rows, the texts right-aligned
        in one prompt at the 16-bucket of the longest (each row its own pad
        hole), with the decoder's sampling (runtime.do_sample; no beams);
        then one latent pass, one CFM solve and one vocoder call over the B
        rows. Conditioning is computed anew (no key is read): emovec, the
        banks' rows blended in under an emo_vector, conds repeated over the
        rows. The decode draws from `seed`, the CFM noise from seed + 1, at
        (B, 80, prompt frames + the 128-bucket of the longest target) and
        cut to the solve's width. A row that stops at once is a stop-only
        row of one code. Each row's mel is filled with log(1e-5) from its
        own target length on and its waveform cut there. One segment takes
        `synthesize_segment`. Stage seconds go to `_last_batched_stats`
        (decode, host_trim, latent, s2mel, vocoder; under TARS_STAGE_SYNC=1
        each stage ends in a wait for the card). Returns the waveforms in
        segment order."""
        rt, g = self.cfg.runtime, self.cfg.gpt
        B = len(segments)
        if B == 1:
            r = self.synthesize_segment(
                spk, emo, np.asarray(segments[0]), emo_alpha=emo_alpha, emo_vector=emo_vector,
                use_random=use_random, max_mel_tokens=max_mel_tokens,
                temperature=temperature, top_p=top_p, seed=seed)
            return [r.wav]
        stats: Dict[str, float] = {}
        t_mark = time.perf_counter()

        def mark(name: str) -> None:
            nonlocal t_mark
            self._stage_barrier()
            now = time.perf_counter()
            stats[name] = stats.get(name, 0.0) + now - t_mark
            t_mark = now

        with torch.inference_mode():
            emovec, conds = self.segment_conds(spk, emo, emo_alpha, emo_vector, use_random,
                                               seed)
            segments = [np.asarray(seg) for seg in segments]
            lens = np.asarray([len(seg) for seg in segments])
            bucket = int(lens.max()) if self.precise else min(
                next_bucket(int(lens.max()), 16, 16), g.max_text_tokens)
            text = np.zeros((B, bucket), np.int64)
            for b, seg in enumerate(segments):
                text[b, :len(seg)] = seg
            ids, pos, valid = self.decoder.build_text_prompt_arrays(text, lens, bucket)
            res = self.decoder.generate(
                conds.expand(B, -1, -1).contiguous(), self._tensor(ids), self._tensor(pos),
                self._tensor(valid), self._seed(seed), max_new=max_mel_tokens or rt.max_mel_tokens,
                temperature=temperature if temperature is not None else rt.temperature,
                top_p=top_p if top_p is not None else rt.top_p,
                repetition_penalty_value=rt.repetition_penalty)
            codes, lengths = res.codes.cpu().numpy(), res.lengths.cpu().numpy()
            mark("decode")
            rows = [self.remove_long_silence(codes[b, :int(lengths[b])], g.stop_mel_token,
                                             compress=rt.remove_long_silence)
                    for b in range(B)]
            code_lens = np.maximum([n for _, n in rows], 1)
            mark("host_trim")
            latent, codes_t = self._latent_rows(spk, emovec, segments, [r for r, _ in rows],
                                                list(code_lens))
            mark("latent")

            target_exact = (code_lens * 1.72).astype(np.int64)
            bucket_len = next_bucket(int(target_exact.max()), 128, 128)
            target_len = int(target_exact.max()) if self.precise else bucket_len
            shape = (B, self.cfg.s2mel.dit.in_channels, spk.ref_mel_len + target_len)
            if self._noise_hook is not None:
                noise = self._tensor(self._noise_hook(shape), torch.float32)
            else:
                noise = torch.randn(
                    (B, shape[1], spk.ref_mel_len + bucket_len), device=self.device,
                    generator=self._generator(None if seed is None else seed + 1)
                )[:, :, :shape[2]]
            vc = self._s2mel_mel(spk, latent, codes_t, code_lens, target_len, noise)
            mel = vc[:, :, spk.ref_mel_len:spk.ref_mel_len + target_len]
            # each row's frames past its own target length are silence
            frame = torch.arange(target_len, device=self.device)
            mel = torch.where(frame[None, None, :] < self._tensor(target_exact)[:, None, None],
                              mel, float(np.log(1e-5)))
            mark("s2mel")
            # the voc_dtype vocoder: bfloat16 under a bfloat16 voc_dtype
            wavs = self._vocode_rows(mel, list(target_exact), self.batch_vocoder_runner)
            mark("vocoder")
        self._last_batched_stats = stats
        return wavs

    def captured_graphs(self) -> Dict[str, int]:
        """The CUDA graphs the engine holds, by stage: decode steps (every
        decode state's), latent passes, CFM solves and vocoder calls (the
        batched route's runner too when it is a runner of its own). Each
        capture keeps its memory pool on the card; all 0 on the CPU."""
        vocoders = {id(r): r for r in (self.vocoder_runner, self.batch_vocoder_runner)}
        return {"decode": sum(len(st.graphs) for st in self.decoder._states.values()),
                "latent": sum(self.latent_runner.keys().values()),
                "s2mel": sum(self.s2mel_runner.keys().values()),
                "vocoder": sum(sum(r.keys().values()) for r in vocoders.values())}

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
        decode a text bucket on the route `num_beams` (default
        runtime.num_beams) gives: `generate`, which captures the step of
        its (1, cap) state, or past one beam `generate_beam`, which
        captures the beam step of its ("beam", nb, cap) state, the one a
        request of that bucket takes. "both" and "keyed" first run `cond_prefill` on the prompt's
        conds, as the JAX engine does (indextts_tpu/runtime/engine.py:
        1074-1077), and decode on the keyed route where the decoder reuses
        the prefix (else on the raw route, as the JAX engine's "keyed" falls
        back); the keyed route's tail prefill runs eagerly and its step is
        the raw route's capture, so one job a bucket serves both. "raw"
        decodes on the raw route; "none" skips decode (continuous serving
        decodes in its own batcher). Latent: one
        pass a (text bucket, code bucket); s2mel: one stage a reachable
        (code bucket, target bucket), its solve keyed on the prompt's frames
        + the target bucket; vocoder: one call a target bucket, through
        the float32 vocoder that serves one row (a bfloat16 voc_dtype's
        model serves only the batched route's keys of B > 1 rows, which the
        grid does not hold, as in the JAX engine). Captures
        take turns (`cuda_lib.capture`); the eager warm-ups before them may
        overlap. On the CPU nothing is captured, and no job runs. With
        `block=False` the jobs go on in the background. Returns the number
        of jobs."""
        rt, g = self.cfg.runtime, self.cfg.gpt
        if decode_variants not in ("both", "keyed", "raw", "none"):
            raise ValueError(f"decode_variants={decode_variants!r}: one of both, keyed, "
                             "raw, none")
        nb = rt.num_beams if num_beams is None else num_beams
        grid = precompile_grid(g.max_text_tokens, rt.max_text_tokens_per_segment,
                               text_buckets, max_code_len, code_lens)
        decode = [] if decode_variants == "none" else grid.text_buckets
        n_jobs = len(decode) + len(grid.latent) + len(grid.s2mel) + len(grid.vocoder)
        if self.device.type != "cuda":
            return n_jobs
        emo = emo if emo is not None else EmotionConditioning(spk.spk_cond_emb, spk.cond_len)
        emovec, conds = self.segment_conds(spk, emo)
        prefix = None
        if decode and decode_variants != "raw" and self.decoder.supports_cond_kv:
            prefix = self.decoder.cond_prefill(conds)
        # the request path's own calls, at each bucket's width
        jobs: List[Callable[[], Any]] = [
            functools.partial(self._generate_codes, conds, np.ones(b, np.int64), prefix,
                              max_mel_tokens=max_new, seed=0, num_beams=nb,
                              do_sample=do_sample)
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

    def _conditioning(self, spk_audio, emo_audio, emo_alpha,
                      emo_vector: Optional[Sequence[float]] = None, use_random: bool = False):
        """(speaker, emotion, alpha, conditioning key). File paths are cache
        keys; (audio, sr) pairs are not cached. With no emotion prompt the
        speaker's features drive the emotion, alpha 1; an emo_vector
        overrides the emotion prompt. The key (speaker path, emotion path
        or "", alpha, tuple(emo_vector) or None), as the JAX engine builds
        `cond_kv_key` (indextts_tpu/runtime/engine.py:1544-1566), exists
        only when both conditionings are file paths and not under
        use_random, whose rows are drawn anew."""
        if emo_vector is not None:
            emo_audio = None
        if isinstance(spk_audio, str):
            spk = self.prepare_speaker(*audio_utils.load_wav(spk_audio), cache_key=spk_audio)
        else:
            spk = self.prepare_speaker(*spk_audio)
        if emo_audio is None:
            emo, emo_alpha, emo_key = EmotionConditioning(spk.spk_cond_emb, spk.cond_len), 1.0, ""
        elif isinstance(emo_audio, str):
            emo = self.prepare_emotion(*audio_utils.load_wav(emo_audio), cache_key=emo_audio)
            emo_key = emo_audio
        else:
            emo, emo_key = self.prepare_emotion(*emo_audio), None
        key = None
        if isinstance(spk_audio, str) and emo_key is not None and not use_random:
            key = (spk_audio, emo_key, float(emo_alpha),
                   None if emo_vector is None else tuple(emo_vector))
        return spk, emo, emo_alpha, key

    def _seq_tail_overlap_enabled(self, n_segments: int) -> bool:
        """The tail overlap serves requests of several segments; it is off
        under TARS_STAGE_SYNC=1, whose stage barriers it would overlap."""
        return (self.cfg.runtime.seq_tail_overlap and n_segments > 1
                and os.environ.get("TARS_STAGE_SYNC", "0") != "1")

    def _segment_results(self, spk, emo, segments: List[np.ndarray], emo_alpha: float,
                         seed: Optional[int], cond_kv_key: Optional[tuple],
                         **gen_kwargs) -> Iterator[SegmentResult]:
        """Each segment's SegmentResult in order, segment i with seed
        seed + i: pipelined when the tail overlap is on, else inline."""
        if self._seq_tail_overlap_enabled(len(segments)):
            yield from self._pipelined_segments(spk, emo, segments, emo_alpha, seed,
                                                cond_kv_key, **gen_kwargs)
            return
        for i, seg in enumerate(segments):
            yield self.synthesize_segment(
                spk, emo, np.asarray(seg), emo_alpha=emo_alpha,
                seed=None if seed is None else seed + i, cond_kv_key=cond_kv_key,
                **gen_kwargs)

    def _pipelined_segments(self, spk, emo, segments: List[np.ndarray], emo_alpha: float,
                            seed: Optional[int], cond_kv_key: Optional[tuple],
                            **gen_kwargs) -> Iterator[SegmentResult]:
        """The JAX engine's decode/tail pipeline (indextts_tpu/runtime/
        engine.py:1384-1467): a producer thread decodes segment k+1 while
        one tail worker (FIFO, so tails end in submission order) finishes
        segment k; yields the SegmentResults strictly in segment order. The
        handoff queue holds 2, so a slow consumer holds the producer back.
        The tail's stream waits for the producer's decode (an event). A
        decode or tail error raises in the caller. Closing the generator
        stops the producer and drops the tails not started without waiting
        for the one running (its result is dropped)."""
        tail_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tars-seq-tail")
        out_q: "queue.Queue[tuple]" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            """A put that gives up once the consumer is gone (a plain put
            could block for good on the bounded queue)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def tail(ready, *args):
            self._after(ready)
            return self._finish_from_codes(*args)

        def producer():
            try:
                for i, seg in enumerate(segments):
                    if stop.is_set():
                        return
                    seg = np.asarray(seg)
                    s_i = None if seed is None else seed + i
                    emovec, codes, t_gen = self._decode_segment_codes(
                        spk, emo, seg, emo_alpha=emo_alpha, seed=s_i,
                        cond_kv_key=cond_kv_key, **gen_kwargs)
                    fut = tail_pool.submit(tail, self._mark(), spk, emovec, seg, codes, s_i,
                                           t_gen)
                    if not put(("fut", fut)):
                        return
                put(("done", None))
            except BaseException as e:  # the caller raises it
                put(("err", e))

        th = threading.Thread(target=producer, daemon=True, name="tars-seq-decode")
        th.start()
        try:
            while True:
                kind, v = out_q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise v
                yield v.result()
        finally:
            stop.set()
            # wait=False: a closed stream does not wait for a tail in flight
            tail_pool.shutdown(wait=False, cancel_futures=True)
            th.join(timeout=60)

    def infer(
        self,
        spk_audio: Union[str, Tuple[np.ndarray, int]],
        text_ids_segments: List[np.ndarray],
        emo_audio: Optional[Union[str, Tuple[np.ndarray, int]]] = None,
        emo_alpha: float = 1.0,
        emo_vector: Optional[Sequence[float]] = None,
        use_random: bool = False,
        interval_silence: int = 200,
        output_path: Optional[str] = None,
        seed: Optional[int] = None,
        batched: bool = False,
        **gen_kwargs: Any,
    ):
        """Synthesis over pre-tokenized segments, in order: with `batched`
        and several segments, all at once (`synthesize_segments_batched`,
        which decodes with the decoder's sampling: num_beams and do_sample
        are dropped, as the JAX engine drops them, and "stats" is empty);
        else pipelined (`_pipelined_segments`) when the tail overlap is on
        and there are several, else one after another. Returns
        {"sampling_rate", "audio", "duration_sec", "rtf", "stats"}."""
        start = time.perf_counter()
        spk, emo, emo_alpha, key = self._conditioning(spk_audio, emo_audio, emo_alpha,
                                                      emo_vector, use_random)
        if batched and len(text_ids_segments) > 1:
            bkw = {k: v for k, v in gen_kwargs.items() if k not in ("num_beams", "do_sample")}
            wavs = self.synthesize_segments_batched(
                spk, emo, list(text_ids_segments), emo_alpha=emo_alpha, emo_vector=emo_vector,
                use_random=use_random, seed=seed, **bkw)
            return self._joined(wavs, [], start, interval_silence, output_path)
        stats = list(self._segment_results(spk, emo, text_ids_segments, emo_alpha, seed, key,
                                           emo_vector=emo_vector, use_random=use_random,
                                           **gen_kwargs))
        return self._joined([r.wav for r in stats], stats, start, interval_silence,
                            output_path)

    def infer_generator(
        self,
        spk_audio: Union[str, Tuple[np.ndarray, int]],
        text_ids_segments: List[np.ndarray],
        emo_audio: Optional[Union[str, Tuple[np.ndarray, int]]] = None,
        emo_alpha: float = 1.0,
        emo_vector: Optional[Sequence[float]] = None,
        use_random: bool = False,
        interval_silence: int = 200,
        seed: Optional[int] = None,
        **gen_kwargs: Any,
    ) -> Iterator[np.ndarray]:
        """Streaming synthesis (indextts_tpu/runtime/engine.py:1300-1372):
        each segment's waveform, then interval_silence ms of silence, the
        last segment's included; the same route, keys and seeds as infer()."""
        spk, emo, emo_alpha, key = self._conditioning(spk_audio, emo_audio, emo_alpha,
                                                      emo_vector, use_random)
        sil = self._silence(interval_silence)
        for r in self._segment_results(spk, emo, text_ids_segments, emo_alpha, seed, key,
                                       emo_vector=emo_vector, use_random=use_random,
                                       **gen_kwargs):
            yield r.wav
            if len(sil):
                yield sil

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
        start = time.perf_counter()
        futs = self._submit_all(service, spk_audio, text_ids_segments, emo_audio, emo_alpha,
                                emo_vector, seed)
        stats = [f.result(timeout=timeout) for f in futs]
        return self._joined([r.wav for r in stats], stats, start, interval_silence, None)

    def infer_generator_continuous(
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
    ) -> Iterator[np.ndarray]:
        """Streaming through a shared ContinuousService (indextts_tpu/
        runtime/engine.py:1469-1516): every segment submitted up front, as
        infer_continuous(); each waveform and the silence after it yielded
        in order as its segment completes."""
        futs = self._submit_all(service, spk_audio, text_ids_segments, emo_audio, emo_alpha,
                                emo_vector, seed)
        sil = self._silence(interval_silence)
        for f in futs:
            yield f.result(timeout=timeout).wav
            if len(sil):
                yield sil

    def _submit_all(self, service, spk_audio, text_ids_segments, emo_audio, emo_alpha,
                    emo_vector, seed) -> list:
        """Submit a request's segments to `service`, segment i with priority
        i (breadth-first admission across requests) and tail seed seed + i.
        The continuous routes take no use_random, as in the JAX engine."""
        spk, emo, emo_alpha, _ = self._conditioning(spk_audio, emo_audio, emo_alpha,
                                                    emo_vector)
        return [service.submit(spk, emo, np.asarray(seg), emo_alpha=emo_alpha,
                               emo_vector=emo_vector,
                               seed=None if seed is None else seed + i, priority=i)
                for i, seg in enumerate(text_ids_segments)]

    def _silence(self, interval_silence: int) -> np.ndarray:
        sr_out = self.cfg.runtime.sampling_rate
        return np.zeros(int(sr_out * interval_silence / 1000.0), np.float32)

    def _joined(self, wavs: List[np.ndarray], stats: List[SegmentResult], start: float,
                interval_silence: int, output_path: Optional[str]):
        """The segments' audio joined by interval_silence ms of silence, as
        infer() returns it."""
        sr_out = self.cfg.runtime.sampling_rate
        sil = self._silence(interval_silence)
        pieces = []
        for i, w in enumerate(wavs):
            pieces.append(w)
            if i < len(wavs) - 1:
                pieces.append(sil)
        wav = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        total = time.perf_counter() - start
        dur = len(wav) / sr_out
        if output_path:
            audio_utils.save_wav(output_path, wav, sr_out)
        return {"sampling_rate": sr_out, "audio": wav, "duration_sec": dur,
                "rtf": total / dur if dur > 0 else float("inf"), "stats": stats}

    def infer_text(self, spk_audio, text: str, use_emo_text: bool = False,
                   emo_text: Optional[str] = None, emo_alpha: float = 1.0,
                   emo_vector: Optional[Sequence[float]] = None,
                   max_text_tokens_per_segment: Optional[int] = None,
                   quick_streaming_tokens: int = 0, **kwargs):
        """Normalize + tokenize + split, then infer (needs a tokenizer)
        (indextts_tpu/runtime/engine.py:1227-1273). use_emo_text: the
        emotion vector is what the attached `qwen_emo` reads in `emo_text`
        (or the text itself). A vector is scaled by alpha clamped to [0, 1],
        each weight cut to 4 decimals, and alpha then set to 1."""
        segments = self.text_segments(text, max_text_tokens_per_segment,
                                      quick_streaming_tokens)
        if use_emo_text:
            if self.qwen_emo is None:
                raise ValueError("use_emo_text requires engine.qwen_emo")
            emo_vector = list(self.qwen_emo.inference(
                emo_text if emo_text is not None else text).values())
        if emo_vector is not None:
            scale = max(0.0, min(1.0, emo_alpha))
            if scale != 1.0:
                emo_vector = [int(x * scale * 10000) / 10000 for x in emo_vector]
            emo_alpha = 1.0
        return self.infer(spk_audio, segments, emo_alpha=emo_alpha, emo_vector=emo_vector,
                          **kwargs)

    def text_segments(self, text: str, max_text_tokens_per_segment: Optional[int] = None,
                      quick_streaming_tokens: int = 0) -> List[np.ndarray]:
        """Normalize + tokenize + split into segments of token ids; with
        quick_streaming_tokens > 0, small first segments until that many
        tokens are out (the streaming first-chunk lever)."""
        if self.tokenizer is None:
            raise ValueError("engine has no tokenizer; pass pre-tokenized segments to infer()")
        max_seg = max_text_tokens_per_segment or self.cfg.runtime.max_text_tokens_per_segment
        segments = self.tokenizer.split_segments(
            self.tokenizer.tokenize(text), max_seg,
            quick_streaming_tokens=quick_streaming_tokens)
        return [np.asarray(self.tokenizer.convert_tokens_to_ids(s), np.int32)
                for s in segments]

"""Typed configuration tree of IndexTTS2 (copy of indextts_tpu/config.py).

Mirrors the reference's OmegaConf YAML (its `checkpoints/config.yaml`)
value-for-value — those values define the checkpoint tensor shapes — plus the
runtime knobs the reference spreads over `TARS_*` env vars
(reference: serve_tars.py:52-75, infer_v2.py:113-126) unified into one tree.

Everything is a frozen dataclass, so configs are hashable and immutable.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


@dataclass(frozen=True)
class MelConfig:
    """STFT/mel front-end parameters (reference: s2mel config + audio.py:45-82)."""

    sample_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None  # None => sr/2
    center: bool = False


@dataclass(frozen=True)
class ConditionModuleConfig:
    """Conformer encoder settings for speaker/emotion conditioning
    (reference: config.yaml:30-43)."""

    output_size: int = 512
    linear_units: int = 2048
    attention_heads: int = 8
    num_blocks: int = 6
    input_layer: str = "conv2d2"
    perceiver_mult: int = 2
    # fixed in the reference ConformerEncoder ctor defaults
    pos_enc_layer_type: str = "rel_pos"
    cnn_module_kernel: int = 15
    macaron_style: bool = False
    use_cnn_module: bool = True
    input_size: int = 1024  # w2v-BERT feature dim


@dataclass(frozen=True)
class GPTConfig:
    """UnifiedVoice AR acoustic model (reference: config.yaml:14-43,
    gpt/model_v2.py:338-455)."""

    model_dim: int = 1280
    layers: int = 24
    heads: int = 20
    max_mel_tokens: int = 1815
    max_text_tokens: int = 600
    number_text_tokens: int = 12000
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    start_text_token: int = 0
    stop_text_token: int = 1
    mel_length_compression: int = 1024
    use_mel_codes_as_input: bool = True
    train_solo_embeddings: bool = False
    condition_type: str = "conformer_perceiver"
    condition_num_latent: int = 32
    max_conditioning_inputs: int = 1
    condition_module: ConditionModuleConfig = field(
        default_factory=ConditionModuleConfig
    )
    emo_condition_module: ConditionModuleConfig = field(
        default_factory=lambda: ConditionModuleConfig(
            output_size=512, linear_units=1024, attention_heads=4, num_blocks=4
        )
    )

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.heads

    @property
    def max_position(self) -> int:
        # reference: model_v2.py:456 seq_length = max_mel + max_text + 2
        return self.max_mel_tokens + self.max_text_tokens + 2

    @property
    def max_mel_position(self) -> int:
        # reference: model_v2.py:426 mel pos table = max_mel_tokens + 2 + cond inputs
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def max_text_position(self) -> int:
        return self.max_text_tokens + 2


@dataclass(frozen=True)
class SemanticCodecConfig:
    """RepCodec semantic VQ (reference: config.yaml:45-51,
    kmeans/repcodec_model.py:34-199)."""

    codebook_size: int = 8192
    hidden_size: int = 1024
    codebook_dim: int = 8
    vocos_dim: int = 384
    vocos_intermediate_dim: int = 2048
    vocos_num_layers: int = 12
    num_quantizers: int = 1
    downsample_scale: int = 1


@dataclass(frozen=True)
class LengthRegulatorConfig:
    """InterpolateRegulator (reference: config.yaml:68-78,
    length_regulator.py:28-141)."""

    channels: int = 512
    is_discrete: bool = False
    in_channels: int = 1024
    content_codebook_size: int = 2048
    sampling_ratios: Tuple[int, ...] = (1, 1, 1, 1)
    vector_quantize: bool = False
    n_codebooks: int = 1
    quantizer_dropout: float = 0.0
    f0_condition: bool = False
    n_f0_bins: int = 512


@dataclass(frozen=True)
class DiTConfig:
    """DiT flow-matching estimator (reference: config.yaml:79-101,
    diffusion_transformer.py:103-257, gpt_fast/model.py:41-64)."""

    hidden_dim: int = 512
    num_heads: int = 8
    depth: int = 13
    class_dropout_prob: float = 0.1
    block_size: int = 8192
    in_channels: int = 80
    style_condition: bool = True
    final_layer_type: str = "wavenet"
    content_dim: int = 512
    content_codebook_size: int = 1024
    content_type: str = "discrete"
    is_causal: bool = False
    long_skip_connection: bool = True
    zero_prompt_speech_token: bool = False
    time_as_token: bool = False
    style_as_token: bool = False
    uvit_skip_connection: bool = True
    style_dim: int = 192  # style_encoder.dim
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    # gpt_fast Transformer hardcodes block_size=16384 for the rope table
    # (reference: diffusion_transformer.py:113)
    rope_table_size: int = 16384
    time_freq_dim: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def intermediate_size(self) -> int:
        # gpt_fast ModelArgs.__post_init__: find_multiple(2*4*dim/3, 256)
        n_hidden = int(2 * (4 * self.hidden_dim) / 3)
        k = 256
        return n_hidden if n_hidden % k == 0 else n_hidden + k - (n_hidden % k)


@dataclass(frozen=True)
class WaveNetConfig:
    """WN final layer of the DiT (reference: config.yaml:102-108, wavenet.py:103)."""

    hidden_dim: int = 512
    num_layers: int = 8
    kernel_size: int = 5
    dilation_rate: int = 1
    p_dropout: float = 0.2
    style_condition: bool = True


@dataclass(frozen=True)
class S2MelConfig:
    """semantic -> mel stage (reference: config.yaml:53-108)."""

    mel: MelConfig = field(default_factory=MelConfig)
    length_regulator: LengthRegulatorConfig = field(
        default_factory=LengthRegulatorConfig
    )
    dit: DiTConfig = field(default_factory=DiTConfig)
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)
    # gpt_layer MLP: 1280 -> 256 -> 128 -> 1024 (reference: commons.py:413)
    gpt_dims: Tuple[int, ...] = (1280, 256, 128, 1024)


@dataclass(frozen=True)
class BigVGANConfig:
    """BigVGAN v2 22 kHz 80-band 256x vocoder.

    Values match the published `nvidia/bigvgan_v2_22khz_80band_256x` config.json
    consumed by the reference (config.yaml:117-119, bigvgan.py:266-358).
    """

    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    resblock: str = "1"
    activation: str = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False
    sampling_rate: int = 22050

    @property
    def total_upsample(self) -> int:
        r = 1
        for u in self.upsample_rates:
            r *= u
        return r


@dataclass(frozen=True)
class W2VBertConfig:
    """facebook/w2v-bert-2.0 encoder (the conditioning feature extractor).

    Mirrors transformers.Wav2Vec2BertConfig defaults, which match the
    released w2v-bert-2.0 checkpoint (reference loads it at infer_v2.py:187-193
    and taps hidden_states[17])."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    num_mel_bins: int = 80
    conv_depthwise_kernel_size: int = 31
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    position_embeddings_type: str = "relative_key"
    layer_norm_eps: float = 1e-5
    tap_layer: int = 17  # hidden_states[17] (reference: infer_v2.py:392,406)


@dataclass(frozen=True)
class CampPlusConfig:
    """CAMPPlus speaker-style encoder (reference: campplus/DTDNN.py:50)."""

    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128


@dataclass(frozen=True)
class QwenEmoConfig:
    """Qwen3-0.6B emotion classifier head config (reference: infer_v2.py:948).

    Architecture constants for Qwen3-0.6B; used to build the flax model when
    the fine-tuned checkpoint is available."""

    vocab_size: int = 151936
    hidden_size: int = 1024
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    max_new_tokens: int = 256


@dataclass(frozen=True)
class RuntimeConfig:
    """Runtime/perf knobs. Env overrides keep the reference's TARS_* names
    (reference: serve_tars.py:52-75, infer_v2.py:113-126)."""

    diffusion_steps: int = 20
    cfg_rate: float = 0.7
    interval_silence_ms: int = 200
    max_text_tokens_per_segment: int = 120
    max_mel_tokens: int = 1500
    sampling_rate: int = 22050
    # sampling defaults (reference: infer_v2.py:714-722)
    do_sample: bool = True
    top_p: float = 0.8
    top_k: int = 30
    temperature: float = 0.8
    length_penalty: float = 0.0
    num_beams: int = 3
    repetition_penalty: float = 10.0
    # compress >30 silent tokens (id 52) down to runs of 10. The reference
    # *defines* this for v2 (infer_v2.py:410-465) but its live v2 path only
    # stop-trims (infer_v2.py:795-807; the compressor is called by v1 only,
    # infer.py:450,639) — so the default matches the reference's live
    # behavior. Set True for the opt-in silence-compression enhancement.
    remove_long_silence: bool = False
    # The knobs below keep the JAX package's names and defaults so that one
    # config tree (and its TARS_* env) drives both packages. The PyTorch port
    # honours the quantized GPT route: gpt_quantize
    # with gpt_wbits=8 (W8A8 blocks) or 4 (W4A8, packed nibbles), head_quant
    # (with gpt_quantize) and an int8 KV cache, which kv_quant or
    # attn_impl="pallas_q8" selects. gemv_impl resolves as in the JAX engine,
    # with the card in the TPU's place (runtime/engine.py resolve_gemv):
    # "pallas" sends the quantized GPT's single-row decode calls through the
    # GEMV and fused-MLP kernels where their gating opens, "xla" through the
    # plain contraction, and "auto" takes the kernels for W4 on CUDA only.
    # attn_impl decides, by the JAX rule, whether a keyed request reuses the
    # conditioning prefix's KV (runtime/decode.py supports_cond_kv); the
    # port's attention runs its own kernels either way. seq_tail_overlap
    # overlaps segment k's tail with segment k+1's decode, as in the JAX
    # engine. s2mel_dtype and voc_dtype ("bfloat16": bfloat16 weights and
    # compute, float32 islands; a bfloat16 vocoder serves the batched route
    # beside a float32 sibling) resolve as in the JAX engine, as from
    # TARS_S2MEL_DTYPE and TARS_VOC_DTYPE. Like the JAX engine it ignores
    # gpt_dtype (the engine's gpt_dtype argument, float32 by default, sets
    # the GPT's). text_prefix_reuse left-aligns a keyed request's prompt and
    # reuses the KV of its text's prefix on the sequential routes, as in the
    # JAX engine (runtime/engine.py `_lookup_text_prefix`).
    # compute dtype for the GPT decode loop ("bfloat16" | "float32")
    gpt_dtype: str = "bfloat16"
    # decode attention implementation in the JAX package: "auto", "xla",
    # "xla_bucketed", "pallas_ragged", "pallas_q8"
    attn_impl: str = "auto"
    # int8 KV cache in the decode loop (per-vector absmax)
    kv_quant: bool = False
    # quantized GPT weights (params through torch_convert.quantize_gpt_tree)
    gpt_quantize: bool = False
    # decode GEMV implementation for quantized weights: "auto", "xla", "pallas"
    gemv_impl: str = "auto"
    # quantized GPT weight bits (requires gpt_quantize): 8 = W8A8, 4 = W4A8
    gpt_wbits: int = 8
    # int8 logits head (requires gpt_quantize)
    head_quant: bool = False
    # s2mel (DiT/CFM + regulator) compute dtype: "float32" | "bfloat16"
    s2mel_dtype: str = "float32"
    # BigVGAN vocoder compute dtype: "float32" | "bfloat16"
    voc_dtype: str = "float32"
    # quantize the waveform to PCM16 on the device before the host transfer
    # (reference output semantics: clamp(32767*wav).int16, infer_v2.py:866).
    # The engine's public float API rescales by 1/32767.
    device_pcm16: bool = True
    # cross-request text-prefix KV reuse (left-aligned prompts); off by default
    text_prefix_reuse: bool = False
    # overlap segment k's cascade tail with segment k+1's decode
    seq_tail_overlap: bool = True
    # static decode-loop bucket sizes (text prompt padded to one of these)
    text_buckets: Tuple[int, ...] = (32, 64, 128)
    # KV cache capacity of the JAX package's compiled decode program
    decode_kv_capacity: int = 2048
    # serving
    max_concurrency: int = 1
    enable_streaming: bool = True

    @staticmethod
    def from_env() -> "RuntimeConfig":
        return RuntimeConfig(
            diffusion_steps=int(os.environ.get("TARS_DIFFUSION_STEPS", "20")),
            max_mel_tokens=int(os.environ.get("TARS_MAX_MEL_TOKENS", "1500")),
            cfg_rate=float(os.environ.get("TARS_CFG_RATE", "0.7")),
            max_concurrency=int(os.environ.get("TARS_MAX_CONCURRENCY", "1")),
            enable_streaming=_env_flag("TARS_ENABLE_STREAMING", True),
            attn_impl=os.environ.get("TARS_ATTN_IMPL", "auto"),
            kv_quant=_env_flag("TARS_KV_QUANT", False),
            # library default stays the reference HF default (3); serve.py
            # sets this to 1 for serving (see its --num-beams rationale)
            num_beams=int(os.environ.get("TARS_NUM_BEAMS", "3")),
            gpt_quantize=_env_flag("TARS_GPT_QUANTIZE", False),
            gpt_wbits=int(os.environ.get("TARS_GPT_WBITS", "8")),
            gemv_impl=os.environ.get("TARS_GEMV_IMPL", "auto"),
            head_quant=_env_flag("TARS_HEAD_QUANT", False),
            s2mel_dtype=os.environ.get("TARS_S2MEL_DTYPE", "float32"),
            voc_dtype=os.environ.get("TARS_VOC_DTYPE", "float32"),
            device_pcm16=_env_flag("TARS_DEVICE_PCM16", True),
            text_prefix_reuse=_env_flag("TARS_PREFIX_REUSE", False),
            seq_tail_overlap=_env_flag("TARS_SEQ_TAIL_OVERLAP", True),
        )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data axis = DP over hosts (DCN); model axis = TP
    over ICI. (data=1, model=1) is single-chip."""

    data: int = 1
    model: int = 1


@dataclass(frozen=True)
class IndexTTS2Config:
    """Top-level config tree for the whole 5-model cascade."""

    gpt: GPTConfig = field(default_factory=GPTConfig)
    semantic_codec: SemanticCodecConfig = field(default_factory=SemanticCodecConfig)
    s2mel: S2MelConfig = field(default_factory=S2MelConfig)
    vocoder: BigVGANConfig = field(default_factory=BigVGANConfig)
    w2vbert: W2VBertConfig = field(default_factory=W2VBertConfig)
    campplus: CampPlusConfig = field(default_factory=CampPlusConfig)
    qwen_emo: QwenEmoConfig = field(default_factory=QwenEmoConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # emotion-matrix bank sizes per emotion group (reference: config.yaml:115)
    emo_num: Tuple[int, ...] = (3, 17, 2, 8, 4, 5, 10, 24)
    # dataset-side 24 kHz mel (reference: config.yaml:5-12), used by v1 tooling
    dataset_mel: MelConfig = field(
        default_factory=lambda: MelConfig(
            sample_rate=24000, n_fft=1024, hop_length=256, win_length=1024, n_mels=100
        )
    )
    version: str = "2.0"


def _cfg_from_yaml_dict(d: dict) -> IndexTTS2Config:
    """Build the typed tree from the reference's config.yaml structure."""
    gpt_d = d.get("gpt", {})
    cm = gpt_d.get("condition_module", {})
    em = gpt_d.get("emo_condition_module", {})

    def _cond(src: dict, base: ConditionModuleConfig) -> ConditionModuleConfig:
        kw = {k: v for k, v in src.items() if k in {f.name for f in dataclasses.fields(ConditionModuleConfig)}}
        return dataclasses.replace(base, **kw)

    gpt_kwargs = {
        k: v
        for k, v in gpt_d.items()
        if k in {f.name for f in dataclasses.fields(GPTConfig)}
        and k not in ("condition_module", "emo_condition_module")
    }
    gpt = GPTConfig(
        **gpt_kwargs,
        condition_module=_cond(cm, ConditionModuleConfig()),
        emo_condition_module=_cond(
            em,
            ConditionModuleConfig(
                output_size=512, linear_units=1024, attention_heads=4, num_blocks=4
            ),
        ),
    )

    sc = d.get("semantic_codec", {})
    codec = SemanticCodecConfig(
        **{k: v for k, v in sc.items() if k in {f.name for f in dataclasses.fields(SemanticCodecConfig)}}
    )

    s2 = d.get("s2mel", {})
    sp = s2.get("preprocess_params", {}).get("spect_params", {})
    fmax = sp.get("fmax", "None")
    mel = MelConfig(
        sample_rate=s2.get("preprocess_params", {}).get("sr", 22050),
        n_fft=sp.get("n_fft", 1024),
        win_length=sp.get("win_length", 1024),
        hop_length=sp.get("hop_length", 256),
        n_mels=sp.get("n_mels", 80),
        fmin=sp.get("fmin", 0),
        fmax=None if fmax in ("None", None) else float(fmax),
    )
    lr = s2.get("length_regulator", {})
    length_regulator = LengthRegulatorConfig(
        channels=lr.get("channels", 512),
        is_discrete=lr.get("is_discrete", False),
        in_channels=lr.get("in_channels", 1024),
        content_codebook_size=lr.get("content_codebook_size", 2048),
        sampling_ratios=tuple(lr.get("sampling_ratios", (1, 1, 1, 1))),
        n_codebooks=lr.get("n_codebooks", 1),
        f0_condition=lr.get("f0_condition", False),
        n_f0_bins=lr.get("n_f0_bins", 512),
    )
    dit_d = s2.get("DiT", {})
    dit = DiTConfig(
        hidden_dim=dit_d.get("hidden_dim", 512),
        num_heads=dit_d.get("num_heads", 8),
        depth=dit_d.get("depth", 13),
        class_dropout_prob=dit_d.get("class_dropout_prob", 0.1),
        block_size=dit_d.get("block_size", 8192),
        in_channels=dit_d.get("in_channels", 80),
        style_condition=dit_d.get("style_condition", True),
        final_layer_type=dit_d.get("final_layer_type", "wavenet"),
        content_dim=dit_d.get("content_dim", 512),
        content_codebook_size=dit_d.get("content_codebook_size", 1024),
        content_type=dit_d.get("content_type", "discrete"),
        is_causal=dit_d.get("is_causal", False),
        long_skip_connection=dit_d.get("long_skip_connection", True),
        zero_prompt_speech_token=dit_d.get("zero_prompt_speech_token", False),
        time_as_token=dit_d.get("time_as_token", False),
        style_as_token=dit_d.get("style_as_token", False),
        uvit_skip_connection=dit_d.get("uvit_skip_connection", True),
        style_dim=s2.get("style_encoder", {}).get("dim", 192),
    )
    wn = s2.get("wavenet", {})
    wavenet = WaveNetConfig(
        hidden_dim=wn.get("hidden_dim", 512),
        num_layers=wn.get("num_layers", 8),
        kernel_size=wn.get("kernel_size", 5),
        dilation_rate=wn.get("dilation_rate", 1),
        p_dropout=wn.get("p_dropout", 0.2),
        style_condition=wn.get("style_condition", True),
    )
    s2mel = S2MelConfig(
        mel=mel, length_regulator=length_regulator, dit=dit, wavenet=wavenet
    )

    ds = d.get("dataset", {}).get("mel", {})
    dataset_mel = MelConfig(
        sample_rate=ds.get("sample_rate", 24000),
        n_fft=ds.get("n_fft", 1024),
        hop_length=ds.get("hop_length", 256),
        win_length=ds.get("win_length", 1024),
        n_mels=ds.get("n_mels", 100),
        fmin=ds.get("mel_fmin", 0),
    )

    return IndexTTS2Config(
        gpt=gpt,
        semantic_codec=codec,
        s2mel=s2mel,
        emo_num=tuple(d.get("emo_num", (3, 17, 2, 8, 4, 5, 10, 24))),
        dataset_mel=dataset_mel,
        runtime=RuntimeConfig.from_env(),
        version=str(d.get("version", "2.0")),
    )


def load_config(path: Optional[str] = None) -> IndexTTS2Config:
    """Load the typed config. With no path, returns the reference defaults."""
    if path is None:
        return IndexTTS2Config(runtime=RuntimeConfig.from_env())
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f)
    return _cfg_from_yaml_dict(d)

"""indextts_tpu_torch — the PyTorch/CUDA port of `indextts_tpu` for NVIDIA
Hopper. Mirrors the JAX package's layout module for module:

  frontend/   text normalization, BPE tokenization, fbank features (copies)
  ops/        hand-written CUDA kernels (csrc/*.cu) behind checked wrappers,
              each beside its plain PyTorch version; STFT/mel
  models/     nn.Module definitions named after the reference state_dict keys
  runtime/    decode loop, CFM solver, engine, HTTP server (copy)
  utils/      audio I/O, the native host DSP (csrc/dsp.cpp via ctypes)
  client.py   HTTP client and REPL (copy)
  weights.py  JAX parameter trees -> the port's state dicts

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

from indextts_tpu_torch.config import IndexTTS2Config, load_config

__version__ = "0.1.0"

__all__ = ["IndexTTS2Config", "load_config", "__version__"]

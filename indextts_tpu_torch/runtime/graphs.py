"""Captured programs: a function replayed from a CUDA graph, one per key.

The port's counterpart of the JAX engine's jitted programs, each compiled
once per bucket of its input shapes. A `GraphRunner` holds, for each key
(the caller's name for a set of input shapes), static input buffers and, on
the card, a CUDA graph of the function captured over them; a call copies
its inputs in, replays the graph and copies the output out. The CPU runs
the function eagerly on the caller's tensors.

Three runners stand on it: runtime/s2mel_infer.py `S2MelRunner` (the CFM
solve, JAX `_s2mel_program`), `LatentRunner` (the teacher-forced latent
pass, JAX `_latent_program`) and `VocoderRunner` (BigVGAN with the PCM16
clip or without, JAX `_vocoder_pcm16_f32_program` / `_vocoder_f32_program`).
Each runner's keys begin with the batch's rows B: a request's segments
batched into one call (the engine's `synthesize_segments_batched`) take
keys of B > 1, which have a budget of their own (`MAX_BATCHED`), so that
they never evict a one-row key that `precompile` warmed.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from indextts_tpu_torch.models.bigvgan import BigVGAN, to_pcm16
from indextts_tpu_torch.models.unified_voice import UnifiedVoice
from indextts_tpu_torch.ops import cuda_lib, snake

# one-row latent-pass keys (1, text width, code width) whose graphs are
# kept: the serving envelope of 512 codes holds 2 text buckets x 8 code buckets
MAX_LATENTS = 16
# one-row vocoder keys (1, mel width) whose graphs are kept: 512 codes reach
# 7 target buckets
MAX_VOCODES = 8
# keys of B > 1 rows whose graphs each runner keeps, apart from its one-row
# keys
MAX_BATCHED = 4


class Program:
    """One key's static inputs, the graph captured over them, its output and
    each counter's launches in one replay. A Python number among the inputs
    is held as a 0-d tensor filled in place (no host-to-device copy)."""

    def __init__(self, args: Sequence, device: torch.device):
        self.args = tuple(
            torch.zeros(a.shape, dtype=a.dtype, device=a.device) if isinstance(a, torch.Tensor)
            else torch.zeros((), dtype=torch.int64 if isinstance(a, int) else torch.float32,
                             device=device)
            for a in args)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Sequence[int] = ()

    def load(self, args: Sequence) -> None:
        for buf, a in zip(self.args, args):
            if not isinstance(a, torch.Tensor):
                buf.fill_(a)
            elif a.shape != buf.shape:
                raise ValueError(f"input of shape {tuple(a.shape)} for a program "
                                 f"captured at {tuple(buf.shape)}")
            else:
                buf.copy_(a)


class GraphRunner:
    """`fn(*args) -> tensor`, captured once per key and replayed.

    On the card a key's first call runs `warmup` (by default `fn` itself)
    eagerly on the runner's stream over the key's static inputs (cuBLAS's
    workspace, cuDNN's set-up, per-device tables), then captures `fn` as a
    CUDA graph (`cuda_lib.capture`: other threads' CUDA calls go on
    meanwhile, other captures wait) into the runner's own memory pool, which
    its keys' graphs share; each call, the first included, replays it. A
    lock serializes a runner's calls (copy in, replay, copy out) on its one
    stream, so the shared pool is safe: no two of its graphs ever run at
    once. Runners do not share pools, so the replays of different runners
    may overlap on the card. A key's first element is its batch's rows B.
    The least recently used of `max_keys` keys of one row, or of
    MAX_BATCHED keys of more, goes with its graph when a new key of its
    kind comes: a batched call never evicts a one-row key, nor the reverse.
    The launches that the kernels of `counters` make in a capture are
    counted once a replay (`LaunchCounter.take_captured`). A capture that
    fails raises; nothing falls back to an eager call.

    `eager=True` runs `fn` eagerly on the same stream and buffers: the
    yardstick a replay is held to. The CPU always runs `fn` eagerly, on the
    caller's tensors. The output is allocated on the caller's stream and
    filled on the runner's, which the caller's stream then waits for."""

    def __init__(self, fn: Callable, device, max_keys: int,
                 counters: Sequence[cuda_lib.LaunchCounter] = (),
                 warmup: Optional[Callable] = None):
        self.fn = fn
        self.warmup = warmup or fn
        self.device = torch.device(device)
        self.max_keys = max_keys
        self.counters = tuple(counters)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.programs: "OrderedDict[Tuple, Program]" = OrderedDict()
        self.lock = threading.Lock()

    def _program(self, key: Tuple, args: Sequence) -> Program:
        prog = self.programs.get(key)
        if prog is None:
            batched = key[0] > 1
            kind = [k for k in self.programs if (k[0] > 1) == batched]
            if len(kind) >= (MAX_BATCHED if batched else self.max_keys):
                # its last replay may still run on the card: the graph and
                # buffers go once the stream is idle
                self.stream.synchronize()
                del self.programs[kind[0]]
            prog = self.programs[key] = Program(args, self.device)
        self.programs.move_to_end(key)
        return prog

    def _capture(self, prog: Program) -> None:
        self.warmup(*prog.args)
        graph = torch.cuda.CUDAGraph()
        for c in self.counters:
            c.take_captured()
        with cuda_lib.capture(graph, self.stream, self.pool):
            prog.out = self.fn(*prog.args)
        prog.graph = graph
        prog.launches = [c.take_captured() for c in self.counters]

    @torch.inference_mode()
    def __call__(self, key: Tuple, *args, eager: bool = False) -> torch.Tensor:
        if self.stream is None:
            return self.fn(*args)
        caller = torch.cuda.current_stream(self.device)
        with self.lock:
            prog = self._program(key, args)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                prog.load(args)
                if eager:
                    res = self.fn(*prog.args)
                else:
                    if prog.graph is None:
                        self._capture(prog)
                    prog.graph.replay()
                    for c, n in zip(self.counters, prog.launches):
                        c.add_replayed(n)
                    res = prog.out
            out = torch.empty(res.shape, dtype=res.dtype, device=res.device)  # caller's stream
            with torch.cuda.stream(self.stream):
                out.copy_(res)
            caller.wait_stream(self.stream)
        return out

    def keys(self) -> Dict[Tuple, bool]:
        """The keys held, least recently used first, and whether each has
        its graph."""
        return {key: prog.graph is not None for key, prog in self.programs.items()}


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


class LatentRunner(GraphRunner):
    """The teacher-forced latent pass of one UnifiedVoice
    (`forward_latent`), a graph per (B, text width, code width). On W8/W4 its
    contractions take the plain int8 path (a call of many rows opens no
    decode kernel), W4 weights unpacked within the graph."""

    def __init__(self, gpt: UnifiedVoice):
        super().__init__(gpt.forward_latent, _device(gpt), MAX_LATENTS)

    def latent(self, spk_latents, text_ids, text_lens, codes, code_lens, emovec,
               eager: bool = False) -> torch.Tensor:
        """(B, codes width, D) from spk_latents (B, 32, D), text ids (B, Lt)
        and their valid lengths (B,), codes (B, Lm) and theirs (B,), emovec
        (B, D)."""
        return self((codes.shape[0], text_ids.shape[1], codes.shape[1]), spk_latents,
                    text_ids, text_lens, codes, code_lens, emovec, eager=eager)


class VocoderRunner(GraphRunner):
    """BigVGAN over mels (B, 80, T), a graph per (B, T); with `pcm16` the
    waveform leaves it clipped to int16 (`to_pcm16`), else in the model's
    dtype. The static mel is in the model's dtype too: a call casts its
    mel before copying it in. K2's launches (37 a call at the default
    config, of its float32 or its bfloat16 instantiation) are counted
    through replays. A runner serves one model, so its keys and graphs
    hold one dtype."""

    def __init__(self, bigvgan: BigVGAN, pcm16: bool):
        fn = (lambda mel: to_pcm16(bigvgan(mel))) if pcm16 else bigvgan
        self.dtype = bigvgan.conv_pre.weight.dtype
        super().__init__(fn, _device(bigvgan), MAX_VOCODES,
                         counters=(snake.counter, snake.bf16_counter))

    def vocode(self, mel, eager: bool = False) -> torch.Tensor:
        return self((mel.shape[0], mel.shape[2]), mel.to(self.dtype), eager=eager)

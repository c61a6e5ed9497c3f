"""CFM inference: the Euler ODE solve with classifier-free guidance.

Counterpart of indextts_tpu/runtime/s2mel_infer.py (reference
s2mel/modules/flow_matching.py:30-115): uniform t grid, CFG by stacking
(cond, null) into one 2B batch per step, prompt frames pinned to zero in the
state and re-injected through prompt_x. The Euler state stays float32.

The JAX package runs the solve as one jitted program (`lax.fori_loop`
inside the engine's `_s2mel_program`). Here `S2MelRunner` holds, for each
solve shape (B, T), static input buffers and, on the card, a CUDA graph of
all `n_steps` steps captured over them; a solve copies its inputs in,
replays the graph and copies the mel out. The CPU runs the same solve
eagerly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from indextts_tpu_torch.models.s2mel import S2Mel
from indextts_tpu_torch.ops import cuda_lib, dit_attention

# solve shapes (B, T) whose buffers and captured graphs are kept
MAX_SOLVES = 8


@torch.inference_mode()
def cfm_inference(model: S2Mel, mu, x_lens, prompt_x, prompt_len, style,
                  noise, n_steps: int = 20, cfg_rate: float = 0.7):
    """mu (B, T, 512); x_lens (B,); prompt_x (B, 80, T) ref mel then zeros;
    prompt_len an int or a 0-d tensor; style (B, 192); noise (B, 80, T).
    Returns the solved mel (B, 80, T)."""
    B, _, T = noise.shape
    in_prompt = (torch.arange(T, device=noise.device) < prompt_len)[None, None, :]
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)
    dt = 1.0 / n_steps
    stacked_prompt = torch.cat([prompt_x, torch.zeros_like(prompt_x)], dim=0)
    stacked_style = torch.cat([style, torch.zeros_like(style)], dim=0)
    stacked_mu = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    stacked_lens = torch.cat([x_lens, x_lens]) if x_lens.shape[0] == B else x_lens
    for step in range(n_steps):
        # t before the update, rounded in float32 as the JAX solver does
        t = float(np.float32(step) * np.float32(dt))
        stacked_t = torch.full((2 * B,), t, dtype=torch.float32, device=noise.device)
        dphi = model.velocity(torch.cat([x, x], dim=0), stacked_prompt, stacked_lens,
                              stacked_t, stacked_style, stacked_mu).float()
        d_cond, d_null = dphi.chunk(2, dim=0)
        d = (1.0 + cfg_rate) * d_cond - cfg_rate * d_null
        x = x + dt * d
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x


class _Solve:
    """The static inputs of one solve shape, the graph captured over them,
    its output and the K3 launches one replay makes."""

    def __init__(self, mu, x_lens, prompt_x, style, noise):
        self.mu, self.x_lens, self.prompt_x, self.style, self.noise = (
            torch.zeros(a.shape, dtype=a.dtype, device=a.device)
            for a in (mu, x_lens, prompt_x, style, noise))
        self.prompt_len = torch.zeros((), dtype=torch.int64, device=noise.device)
        self.graph = None
        self.out = None
        self.launches = 0


class S2MelRunner:
    """The CFM solve of one S2Mel, `n_steps` Euler steps at `cfg_rate`.

    On the card a solve shape's first call runs one velocity step eagerly
    on the runner's stream (cuBLAS's workspace, cuDNN's set-up, the DiT's
    RoPE table), then captures the whole solve as a CUDA graph
    (`cuda_lib.capture`: other threads' CUDA calls go on meanwhile, other
    captures wait) into one memory pool that every shape's graph shares; each
    call, the first included, replays it. A lock serializes the calls: copy
    in, replay, copy out. So the shared pool is safe, and threads that
    solve at once queue on the card, not on the interpreter. The least
    recently used of MAX_SOLVES shapes goes with its graph. K3's launches in
    a capture are counted once a replay (`LaunchCounter.take_captured`). A
    capture that fails raises.

    `solve(..., eager=True)` runs the same steps eagerly on the same stream
    and buffers: the yardstick a replay is held to. The CPU always runs
    them eagerly, on the caller's tensors."""

    def __init__(self, model: S2Mel, n_steps: int = 20, cfg_rate: float = 0.7):
        self.model = model
        self.n_steps = n_steps
        self.cfg_rate = cfg_rate
        self.device = next(model.parameters()).device
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self._solves: "OrderedDict[Tuple[int, int], _Solve]" = OrderedDict()
        self._lock = threading.Lock()

    def _run(self, st: _Solve, n_steps: int):
        return cfm_inference(self.model, st.mu, st.x_lens, st.prompt_x, st.prompt_len,
                             st.style, st.noise, n_steps=n_steps, cfg_rate=self.cfg_rate)

    def _solve_state(self, mu, x_lens, prompt_x, style, noise) -> _Solve:
        key = (noise.shape[0], noise.shape[2])
        st = self._solves.get(key)
        if st is None:
            if len(self._solves) >= MAX_SOLVES:
                # its last replay may still run on the card: the graph and
                # buffers go once the stream is idle
                self._stream.synchronize()
                self._solves.popitem(last=False)
            st = self._solves[key] = _Solve(mu, x_lens, prompt_x, style, noise)
        self._solves.move_to_end(key)
        return st

    def _capture(self, st: _Solve) -> None:
        self._run(st, 1)
        graph = torch.cuda.CUDAGraph()
        dit_attention.counter.take_captured()
        with cuda_lib.capture(graph, self._stream, self.pool):
            st.out = self._run(st, self.n_steps)
        st.graph, st.launches = graph, dit_attention.counter.take_captured()

    @torch.inference_mode()
    def solve(self, mu, x_lens, prompt_x, prompt_len: int, style, noise,
              eager: bool = False):
        """The solved mel (B, 80, T) from mu (B, T, 512), x_lens (B,) int64,
        prompt_x (B, 80, T), the prompt's frames, style (B, 192) and noise
        (B, 80, T), as `cfm_inference`. On the card the result is a replay
        of the shape's captured graph unless `eager`."""
        if self._stream is None:
            return cfm_inference(self.model, mu, x_lens, prompt_x, prompt_len, style,
                                 noise, n_steps=self.n_steps, cfg_rate=self.cfg_rate)
        caller = torch.cuda.current_stream(self.device)
        out = torch.empty_like(noise)  # the caller's stream's memory
        with self._lock:
            st = self._solve_state(mu, x_lens, prompt_x, style, noise)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                for buf, a in ((st.mu, mu), (st.x_lens, x_lens), (st.prompt_x, prompt_x),
                               (st.style, style), (st.noise, noise)):
                    buf.copy_(a)
                st.prompt_len.fill_(prompt_len)
                if eager:
                    out.copy_(self._run(st, self.n_steps))
                else:
                    if st.graph is None:
                        self._capture(st)
                    st.graph.replay()
                    dit_attention.counter.add_replayed(st.launches)
                    out.copy_(st.out)
            caller.wait_stream(self._stream)
        return out

    def shapes(self):
        """The solve shapes (B, T) held, least recently used first, and
        whether each has its graph."""
        return [(key, st.graph is not None) for key, st in self._solves.items()]


@torch.inference_mode()
def length_regulate(model: S2Mel, x, ylens, out_len: int, xlens=None):
    return model.regulate(x, ylens, out_len, xlens)


@torch.inference_mode()
def project_gpt_latent(model: S2Mel, x):
    return model.project_gpt_latent(x)

"""CFM inference: the Euler ODE solve with classifier-free guidance.

Counterpart of indextts_tpu/runtime/s2mel_infer.py (reference
s2mel/modules/flow_matching.py:30-115): uniform t grid, CFG by stacking
(cond, null) into one 2B batch per step, prompt frames pinned to zero in the
state and re-injected through prompt_x. The Euler state, the CFG combine
and the update stay float32; the DiT's stacked inputs are cast to its
parameters' dtype (runtime.s2mel_dtype), its velocity back to float32.

The JAX package runs the solve as one jitted program (`lax.fori_loop`
inside the engine's `_s2mel_program`). Here `S2MelRunner` (a
runtime/graphs.py `GraphRunner`) holds, for each solve shape (B, T),
static input buffers and, on the card, a CUDA graph of all `n_steps` steps
captured over them; a solve copies its inputs in, replays the graph and
copies the mel out. The CPU runs the same solve eagerly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from indextts_tpu_torch.models.layers import dtype_of
from indextts_tpu_torch.models.s2mel import S2Mel
from indextts_tpu_torch.ops import dit_attention
from indextts_tpu_torch.runtime.graphs import GraphRunner

# one-row solve shapes (1, T) whose buffers and captured graphs are kept: at
# least the 7 target buckets of the serving envelope (512 codes) for one
# prompt; shapes of B > 1 rows have a budget of their own
# (runtime/graphs.py MAX_BATCHED)
MAX_SOLVES = 8


@torch.inference_mode()
def cfm_inference(model: S2Mel, mu, x_lens, prompt_x, prompt_len, style,
                  noise, n_steps: int = 20, cfg_rate: float = 0.7):
    """mu (B, T, 512); x_lens (B,); prompt_x (B, 80, T) ref mel then zeros;
    prompt_len an int or a 0-d tensor; style (B, 192); noise (B, 80, T).
    Returns the solved mel (B, 80, T)."""
    B, _, T = noise.shape
    dt_model = dtype_of(model)
    in_prompt = (torch.arange(T, device=noise.device) < prompt_len)[None, None, :]
    x = torch.where(in_prompt, torch.zeros_like(noise), noise)
    dt = 1.0 / n_steps
    stacked_prompt = torch.cat([prompt_x, torch.zeros_like(prompt_x)], dim=0).to(dt_model)
    stacked_style = torch.cat([style, torch.zeros_like(style)], dim=0).to(dt_model)
    stacked_mu = torch.cat([mu, torch.zeros_like(mu)], dim=0).to(dt_model)
    stacked_lens = torch.cat([x_lens, x_lens]) if x_lens.shape[0] == B else x_lens
    for step in range(n_steps):
        # t before the update, rounded in float32 as the JAX solver does
        t = float(np.float32(step) * np.float32(dt))
        stacked_t = torch.full((2 * B,), t, dtype=torch.float32, device=noise.device)
        dphi = model.velocity(torch.cat([x, x], dim=0).to(dt_model), stacked_prompt, stacked_lens,
                              stacked_t, stacked_style, stacked_mu).float()
        d_cond, d_null = dphi.chunk(2, dim=0)
        d = (1.0 + cfg_rate) * d_cond - cfg_rate * d_null
        x = x + dt * d
        x = torch.where(in_prompt, torch.zeros_like(x), x)
    return x


class S2MelRunner(GraphRunner):
    """The CFM solve of one S2Mel, `n_steps` Euler steps at `cfg_rate`, a
    graph per solve shape (B, T) (runtime/graphs.py `GraphRunner`; at most
    MAX_SOLVES of one row kept, and MAX_BATCHED of more). A shape's first
    call on the card runs one velocity step eagerly before the capture; K3's
    launches are counted through replays. `solve(..., eager=True)` runs the
    same steps eagerly on the runner's stream and buffers: the yardstick a
    replay is held to. The CPU always runs them eagerly, on the caller's
    tensors."""

    def __init__(self, model: S2Mel, n_steps: int = 20, cfg_rate: float = 0.7):
        self.model = model
        self.n_steps = n_steps
        self.cfg_rate = cfg_rate
        super().__init__(functools.partial(self._run, n_steps=n_steps),
                         next(model.parameters()).device, MAX_SOLVES,
                         counters=(dit_attention.counter, dit_attention.bf16_counter),
                         warmup=functools.partial(self._run, n_steps=1))

    def _run(self, mu, x_lens, prompt_x, prompt_len, style, noise, n_steps: int):
        return cfm_inference(self.model, mu, x_lens, prompt_x, prompt_len, style, noise,
                             n_steps=n_steps, cfg_rate=self.cfg_rate)

    def solve(self, mu, x_lens, prompt_x, prompt_len: int, style, noise,
              eager: bool = False):
        """The solved mel (B, 80, T) from mu (B, T, 512), x_lens (B,) int64,
        prompt_x (B, 80, T), the prompt's frames, style (B, 192) and noise
        (B, 80, T), as `cfm_inference`. On the card the result is a replay
        of the shape's captured graph unless `eager`."""
        return self((noise.shape[0], noise.shape[2]), mu, x_lens, prompt_x, prompt_len,
                    style, noise, eager=eager)

    def shapes(self):
        """The solve shapes (B, T) held, least recently used first, and
        whether each has its graph."""
        return list(self.keys().items())


@torch.inference_mode()
def length_regulate(model: S2Mel, x, ylens, out_len: int, xlens=None):
    return model.regulate(x, ylens, out_len, xlens)


@torch.inference_mode()
def project_gpt_latent(model: S2Mel, x):
    return model.project_gpt_latent(x)

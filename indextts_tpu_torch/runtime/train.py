"""Training steps: the GPT's text + mel cross-entropy and the s2mel CFM
flow-matching step.

Counterpart of indextts_tpu/runtime/train.py. The losses are the JAX
package's: `mel_text_loss` weighs the text head's cross-entropy by 0.01
against the mel head's (UnifiedVoice.forward_train); `cfm_loss` is the
conditional flow-matching loss over the OT path y = (1 - (1 - sigma) t) z +
t x1 with target velocity u = x1 - (1 - sigma) z, the prompt frames pinned
(prompt carries the reference mel, y is zeroed there) and the error
averaged per sample over its own (prompt_len, x_len) window, as one masked
reduction.

The steps are stateful, as PyTorch is: `make_train_step(model, optimizer)`
and `make_cfm_train_step(model, optimizer, ...)` return a `step(batch, ...)
-> loss` that updates the model's parameters and the optimizer's state in
place, where the JAX steps return new ones. `adamw(params, lr)` is
torch.optim.AdamW set to what `optax.adamw(lr)` computes: betas (0.9,
0.999), eps 1e-8, weight decay 1e-4 (PyTorch's default is 1e-2) on every
parameter. optax decays every leaf of the tree, a leaf the loss does not
reach too (its gradient is zero), where torch.optim skips a parameter
without a gradient: each step gives such a parameter a zero gradient, so
it decays as in the JAX step.

The CFM step draws t ~ U[0, 1), z ~ N(0, 1) and the per-sample CFG drop
from an explicit torch.Generator on the batch's device (`cfm_noise`); JAX's
and PyTorch's streams differ, so `cfm_loss` takes t, z and drop as
arguments, as the JAX one does, and the step takes them ready-made too.

On the card the DiT's attention trains through kernels K3 (with its row
statistics), K9 and K10 (ops/dit_attention.py), at all its heads or, cut
over a mesh's model axis (`train_model(..., mesh=)`), at this rank's; the
GPT's attention stays plain, as XLA computes it in the JAX package. Float32 only: a bfloat16
model does not train in the JAX package either.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from indextts_tpu_torch.models.s2mel import S2Mel
from indextts_tpu_torch.models.unified_voice import UnifiedVoice
from indextts_tpu_torch.parallel.sharding import DIT_PARTITION_RULES, GPT_PARTITION_RULES, Mesh
from indextts_tpu_torch.parallel.tp import tensor_parallel

Batch = Dict[str, torch.Tensor]


def adamw(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.AdamW:
    """`optax.adamw(lr)` with its defaults, decay on every parameter."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _descend(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             loss_fn: Callable[[], torch.Tensor],
             grad_sync: Optional[Callable[[torch.nn.Module], None]] = None) -> torch.Tensor:
    """One optimizer step on loss_fn()'s gradients; every parameter has a
    gradient, zero where the loss does not reach it (optax's decay).
    `grad_sync(model)` runs between the backward pass and the step (the
    data axis's gradient average, parallel/data.py)."""
    optimizer.zero_grad(set_to_none=False)
    loss = loss_fn()
    loss.backward()
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    if grad_sync is not None:
        grad_sync(model)
    optimizer.step()
    return loss.detach()


# ---------------------------------------------------------------------------
# GPT: text + mel cross-entropy
# ---------------------------------------------------------------------------


def mel_text_loss(model: UnifiedVoice, spk_latents, text_ids, text_lens, mel_codes, mel_lens,
                  emovec) -> torch.Tensor:
    """0.01 x the text head's mean cross-entropy + the mel head's, over
    every position of forward_train's targets (a model with a text_head)."""
    text_logits, mel_logits, text_tar, mel_tar = model.forward_train(
        spk_latents, text_ids, text_lens, mel_codes, mel_lens, emovec)
    lt = F.cross_entropy(text_logits.flatten(0, 1), text_tar.flatten())
    lm = F.cross_entropy(mel_logits.flatten(0, 1), mel_tar.flatten())
    return 0.01 * lt + lm


def make_train_step(model: UnifiedVoice, optimizer: torch.optim.Optimizer,
                    grad_sync: Optional[Callable[[torch.nn.Module], None]] = None):
    """step(batch) -> loss: one AdamW step of `mel_text_loss` on batch
    {"spk_latents", "text_ids", "text_lens", "mel_codes", "mel_lens",
    "emovec"}; `grad_sync` as `_descend`'s."""

    def step(batch: Batch) -> torch.Tensor:
        return _descend(model, optimizer, lambda: mel_text_loss(
            model, batch["spk_latents"], batch["text_ids"], batch["text_lens"],
            batch["mel_codes"], batch["mel_lens"], batch["emovec"]), grad_sync)

    return step


# ---------------------------------------------------------------------------
# s2mel CFM (conditional flow matching)
# ---------------------------------------------------------------------------


def cfm_loss(model: S2Mel, x1, x_lens, prompt_lens, mu, style, t, z,
             drop_cond: Optional[torch.Tensor] = None, sigma_min: float = 1e-6,
             loss_type: str = "l2",
             zero_prompt_speech_token: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1 (B, 80, T) target mel; x_lens, prompt_lens (B,); mu (B, T,
    content_dim); style (B, style_dim); t (B,) diffusion times; z (B, 80,
    T) noise; drop_cond None or (B,) bool. Returns (loss, y_flow), y_flow =
    the estimate + (1 - sigma) z."""
    B, C, T = x1.shape
    frame = torch.arange(T, device=x1.device)[None, :]
    in_prompt = frame < prompt_lens[:, None]  # (B, T)
    valid = frame < x_lens[:, None]

    t3 = t[:, None, None].to(x1.dtype)
    y = (1.0 - (1.0 - sigma_min) * t3) * z + t3 * x1
    u = x1 - (1.0 - sigma_min) * z

    zero = torch.zeros((), dtype=x1.dtype, device=x1.device)
    prompt = torch.where(in_prompt[:, None, :], x1, zero)
    y = torch.where(in_prompt[:, None, :], zero, y)
    mu_in = torch.where(in_prompt[:, :, None], zero, mu) if zero_prompt_speech_token else mu

    est = model.velocity(y, prompt, x_lens, t, style, mu_in, drop_cond)

    win = (valid & ~in_prompt)[:, None, :]  # (B, 1, T)
    diff = torch.where(win, (est - u).float(), torch.zeros((), device=x1.device))
    per_elem = diff.square() if loss_type == "l2" else diff.abs()
    n_b = torch.clamp(win.sum(dim=(1, 2)) * C, min=1).float()  # elements a sample
    loss_b = per_elem.sum(dim=(1, 2)) / n_b
    return loss_b.mean(), est + (1.0 - sigma_min) * z


def cfm_noise(batch: Batch, generator: torch.Generator, class_dropout_prob: float = 0.1):
    """(t, z, drop) for one CFM step, drawn from `generator` on the batch's
    device in that order: t (B,) ~ U[0, 1), z ~ N(0, 1) like x1, drop (B,)
    bool with probability class_dropout_prob, None at 0."""
    x1 = batch["x1"]
    B = x1.shape[0]
    t = torch.rand((B,), generator=generator, device=x1.device)
    z = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    drop = (torch.rand((B,), generator=generator, device=x1.device) < class_dropout_prob
            if class_dropout_prob > 0.0 else None)
    return t, z, drop


def make_cfm_train_step(model: S2Mel, optimizer: torch.optim.Optimizer,
                        class_dropout_prob: float = 0.1, sigma_min: float = 1e-6,
                        loss_type: str = "l2", zero_prompt_speech_token: bool = False,
                        grad_sync: Optional[Callable[[torch.nn.Module], None]] = None):
    """step(batch, generator=None, noise=None) -> loss: one AdamW step of
    `cfm_loss` on batch {"x1", "x_lens", "prompt_lens", "mu", "style"},
    with per-sample CFG dropout at `class_dropout_prob`. `noise` is (t, z,
    drop); without it they are drawn from `generator` (`cfm_noise`).
    `grad_sync` as `_descend`'s."""

    def step(batch: Batch, generator: Optional[torch.Generator] = None,
             noise=None) -> torch.Tensor:
        if noise is None:
            if generator is None:
                raise ValueError("the CFM step needs a generator or its noise")
            noise = cfm_noise(batch, generator, class_dropout_prob)
        t, z, drop = noise
        return _descend(model, optimizer, lambda: cfm_loss(
            model, batch["x1"], batch["x_lens"], batch["prompt_lens"], batch["mu"],
            batch["style"], t, z, drop, sigma_min=sigma_min, loss_type=loss_type,
            zero_prompt_speech_token=zero_prompt_speech_token)[0], grad_sync)

    return step


# ---------------------------------------------------------------------------
# the trained models
# ---------------------------------------------------------------------------


def train_model(cfg, target: str, device, state_dict=None, seed: int = 0,
                mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """The float32 model that `target` ("gpt": UnifiedVoice with its
    text_head; "cfm": S2Mel) trains, on `device`, its parameters requiring
    grad: `state_dict` (the full layout) loaded (strict), else drawn from
    `seed` (each module's PyTorch initialization, as runtime/engine.py
    random_params). With a `mesh` whose model axis is above 1, the model is
    then cut over it by the target's rules (parallel/tp.py
    `tensor_parallel`), before an optimizer is built on its parameters."""
    dev = torch.device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        with dev:
            model = (UnifiedVoice(cfg.gpt, text_head=True) if target == "gpt"
                     else S2Mel(cfg.s2mel))
    if state_dict is not None:
        model.load_state_dict({k: v.to(dev, torch.float32) if v.is_floating_point()
                               else v.to(dev) for k, v in state_dict.items()}, strict=True)
    model.eval().requires_grad_(True)
    if mesh is not None and mesh.shape["model"] > 1:
        tensor_parallel(model, mesh, GPT_PARTITION_RULES if target == "gpt"
                        else DIT_PARTITION_RULES)
    return model

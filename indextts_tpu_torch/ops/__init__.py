"""The port's hand-written kernels (csrc/) and their plain versions."""

from __future__ import annotations

import importlib
from typing import Dict

from indextts_tpu_torch.ops.cuda_lib import LaunchCounter

# every kernel's short name, its wrapper's name, and the module of ops/ and
# the attribute that hold its launch counter
KERNELS = (
    ("K1", "ragged_decode_attention", "decode_attention", "counter"),
    ("K2", "anti_alias_snake", "snake", "counter"),
    ("K3", "dit_attention", "dit_attention", "counter"),
    ("K4", "ragged_decode_attention_q8", "decode_attention", "q8_counter"),
    ("K5", "gemv_w8", "gemv", "gemv_counter"),
    ("K6", "mlp_w8", "gemv", "mlp_counter"),
    ("K7", "gemv_w4", "gemv", "gemv4_counter"),
    ("K8", "mlp_w4", "gemv", "mlp4_counter"),
    ("K2-bf16", "anti_alias_snake", "snake", "bf16_counter"),
    ("K3-bf16", "dit_attention", "dit_attention", "bf16_counter"),
    ("K9", "dit_attention_bwd_dkv", "dit_attention", "bwd_dkv_counter"),
    ("K10", "dit_attention_bwd_dq", "dit_attention", "bwd_dq_counter"),
)


def launch_counters(long_names: bool = False) -> Dict[str, LaunchCounter]:
    """Each kernel's launch counter (`cuda_lib.LaunchCounter`) by its short
    name ("K5"), or with `long_names` by its short name and its wrapper's
    ("K5 gemv_w8"). A counter moves only where its wrapper launches the
    kernel (CUDA tensors), captured calls once a replay."""
    return {f"{k} {fn}" if long_names else k:
            getattr(importlib.import_module(f"indextts_tpu_torch.ops.{mod}"), attr)
            for k, fn, mod, attr in KERNELS}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches of each kernel since `before` (a `launch_snapshot`),
    the kernels that launched none left out."""
    now = launch_snapshot()
    return {k: now[k] - before.get(k, 0) for k in now if now[k] != before.get(k, 0)}


def launch_snapshot() -> Dict[str, int]:
    """Each kernel's launches so far, by short name."""
    return {k: c.launches for k, c in launch_counters().items()}

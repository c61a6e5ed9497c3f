"""The offline tools on the port, each run as
`python -m indextts_tpu_torch.tools.<name>` with the CLI of the JAX
package's tools/<name>.py: `verify_checkpoint`, `voice_conditioning`,
`build_dataset`, `synthesize_clips`, each building its engine on the card
unless `--device cpu` is given; `env_check`, which checks the card (or,
with `--device cpu`, the CPU route); `run_server_test`, which checks a
live server; `eval_quality`, the quality harness (WER through a pluggable
ASR, CAMPPlus speaker similarity, emotion-vector fidelity, negative
controls) over a JSONL of cases; `soak_server`, the serving soak gate
(host RSS, device memory and p50 drift over waves of requests against an
in-process server, exit 1 past a gate). The measurement tools beside
`python -m indextts_tpu_torch.bench`: `benchmark_infer` (a JSONL of cases:
GenTime, AudioDur, RTF, peak device memory), `bench_server_concurrent`
(concurrent HTTP clients against an in-process server, one serving mode
a process; `run_server_bench.sh` and `run_prefix_bench.sh` run two and
merge them), `bench_s2mel` (the fp32 against the bf16 CFM solve),
`bench_w4` (W4A8 against W8A8 decode) and `bench_decode_kernels` (the
port's decode dispatch: `gemv_impl`, the KV cache)."""

from __future__ import annotations

from typing import Optional


def make_engine(model_dir: Optional[str], device=None, cfg_path: Optional[str] = None):
    """The engine a tool synthesizes with: from the checkpoint directory
    `model_dir` (runtime/loader.py `load_engine`), else the configuration
    (`cfg_path` or the defaults) with seeded random weights (seed 0)."""
    if model_dir:
        from indextts_tpu_torch.runtime.loader import load_engine

        return load_engine(model_dir, cfg_path=cfg_path, device=device)
    from indextts_tpu_torch.config import load_config
    from indextts_tpu_torch.runtime.engine import IndexTTS2Engine, random_params

    cfg = load_config(cfg_path)
    return IndexTTS2Engine(cfg, random_params(cfg, seed=0, device=device), device=device)


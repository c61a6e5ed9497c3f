"""Parallel TTS corpus builder on the port.

Counterpart of tools/build_dataset.py, with its flags, inputs and outputs:
multi-worker synthesis over a JSONL manifest with

  * the thread backend: one shared engine and an accelerator semaphore
    (--max-accelerator-concurrency) around its calls;
  * the process backend: an engine in each worker process, started by the
    "spawn" method (CUDA does not survive a fork), each writing its own
    manifest, merged into manifest.jsonl at the end;
  * --mock-inference: deterministic synthetic audio from the text hash, no
    model loaded, for the pipeline and its throughput;
  * deterministic seeding (--deterministic --seed N): each utterance's seed
    from SHA-256 of "seed:id", as the JAX tool derives it;
  * resume: the ids already in manifest.jsonl are skipped (and no engine
    is built where nothing is left to synthesize);
  * a manifest flushed line by line under a lock.

Input JSONL rows: {"id": str, "text": str, optional "spk_audio": str,
"emo_vector": [8 floats], "emo_audio": str}.
Output: out_dir/wavs/<id>.wav + out_dir/manifest.jsonl rows
{"id", "text", "wav", "duration_sec", "worker", "elapsed_s"} (or {"id",
"error", "worker"}).

It synthesizes on the card unless --device cpu is given.

  python -m indextts_tpu_torch.tools.build_dataset --input corpus.jsonl \\
      --out-dir data/ --workers 2 --model-dir checkpoints --spk-audio voice.wav
"""

from __future__ import annotations

import argparse
import hashlib
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


@dataclass
class SynthesisTask:
    uid: str
    text: str
    spk_audio: Optional[str] = None
    emo_vector: Optional[List[float]] = None
    emo_audio: Optional[str] = None


@dataclass
class PipelineConfig:
    input_jsonl: str
    out_dir: str
    workers: int = 1
    backend: str = "thread"  # thread | process
    mock_inference: bool = False
    deterministic: bool = False
    seed: int = 0
    max_accel_concurrency: int = 1
    model_dir: Optional[str] = None
    default_spk_audio: Optional[str] = None
    sample_rate: int = 22050
    device: Optional[str] = None


def mock_synthesize(text: str, sample_rate: int = 22050) -> np.ndarray:
    """Deterministic sine-ish audio from the text hash: 0.5-2.5 s."""
    h = hashlib.sha256(text.encode()).digest()
    dur = 0.5 + (h[0] / 255.0) * 2.0
    freq = 120.0 + h[1] * 3.0
    t = np.arange(int(dur * sample_rate)) / sample_rate
    w = 0.2 * np.sin(2 * np.pi * freq * t) * np.exp(-0.5 * t)
    return w.astype(np.float32)


def load_tasks(path: str) -> List[SynthesisTask]:
    tasks = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            tasks.append(SynthesisTask(uid=str(row.get("id", i)), text=row["text"],
                                       spk_audio=row.get("spk_audio"),
                                       emo_vector=row.get("emo_vector"),
                                       emo_audio=row.get("emo_audio")))
    return tasks


def load_completed(manifest_path: Path) -> set:
    done = set()
    if manifest_path.exists():
        with open(manifest_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)["id"])
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


class ManifestWriter:
    """Append-and-flush manifest, one line a write under a lock."""

    def __init__(self, path: Path):
        self.lock = threading.Lock()
        self.f = open(path, "a")

    def write(self, row: Dict):
        with self.lock:
            self.f.write(json.dumps(row, ensure_ascii=False) + "\n")
            self.f.flush()

    def close(self):
        with self.lock:
            self.f.close()


def _make_engine(cfg: PipelineConfig):
    if cfg.mock_inference:
        return None
    from indextts_tpu_torch.tools import make_engine

    return make_engine(cfg.model_dir, cfg.device)


def _task_seed(cfg: PipelineConfig, task: SynthesisTask) -> Optional[int]:
    if not cfg.deterministic:
        return None
    h = hashlib.sha256(f"{cfg.seed}:{task.uid}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def _synthesize(engine, cfg: PipelineConfig, task: SynthesisTask,
                accel_sem: Optional[threading.Semaphore]) -> np.ndarray:
    if cfg.mock_inference:
        return mock_synthesize(task.text, cfg.sample_rate)
    from indextts_tpu_torch.frontend.tokenizer import byte_fallback_ids

    spk = task.spk_audio or cfg.default_spk_audio
    if spk is None:
        raise ValueError(f"task {task.uid}: no speaker audio")
    kwargs = {}
    if task.emo_vector:
        kwargs["emo_vector"] = engine.normalize_emo_vec(task.emo_vector)
    if task.emo_audio:
        kwargs["emo_audio"] = task.emo_audio
    seed = _task_seed(cfg, task)

    def run():
        if engine.tokenizer is not None:
            return engine.infer_text(spk, task.text, seed=seed, **kwargs)
        ids = byte_fallback_ids(task.text, engine.cfg.gpt.number_text_tokens)
        return engine.infer(spk, [ids], seed=seed, **kwargs)

    if accel_sem is not None:
        with accel_sem:
            out = run()
    else:
        out = run()
    return out["audio"]


def worker_loop(wid: int, cfg: PipelineConfig, engine, task_q: "queue.Queue",
                manifest: ManifestWriter, accel_sem, wav_dir: Path):
    from indextts_tpu_torch.utils.audio import save_wav

    while True:
        try:
            task = task_q.get_nowait()
        except queue.Empty:
            return
        t0 = time.perf_counter()
        try:
            wav = _synthesize(engine, cfg, task, accel_sem)
            wav_path = wav_dir / f"{task.uid}.wav"
            save_wav(str(wav_path), wav, cfg.sample_rate)
            manifest.write({"id": task.uid, "text": task.text, "wav": str(wav_path),
                            "duration_sec": round(len(wav) / cfg.sample_rate, 3),
                            "worker": wid, "elapsed_s": round(time.perf_counter() - t0, 3)})
        except Exception as e:  # recorded in the manifest; the other tasks go on
            manifest.write({"id": task.uid, "error": str(e), "worker": wid})
        finally:
            task_q.task_done()


def _queue(tasks: List[SynthesisTask]) -> "queue.Queue":
    q: "queue.Queue" = queue.Queue()
    for t in tasks:
        q.put(t)
    return q


def run_thread_backend(cfg: PipelineConfig, tasks: List[SynthesisTask]):
    out = Path(cfg.out_dir)
    wav_dir = out / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    manifest = ManifestWriter(out / "manifest.jsonl")
    engine = _make_engine(cfg) if tasks else None
    accel_sem = None if cfg.mock_inference else threading.Semaphore(cfg.max_accel_concurrency)
    q = _queue(tasks)
    threads = [threading.Thread(target=worker_loop,
                                args=(i, cfg, engine, q, manifest, accel_sem, wav_dir),
                                daemon=True)
               for i in range(cfg.workers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    manifest.close()


def _process_worker(wid: int, cfg_dict: dict, task_dicts: List[dict]):
    cfg = PipelineConfig(**cfg_dict)
    out = Path(cfg.out_dir)
    wav_dir = out / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    manifest = ManifestWriter(out / f"manifest.worker{wid}.jsonl")
    engine = _make_engine(cfg) if task_dicts else None
    worker_loop(wid, cfg, engine, _queue([SynthesisTask(**t) for t in task_dicts]), manifest,
                None, wav_dir)
    manifest.close()


def run_process_backend(cfg: PipelineConfig, tasks: List[SynthesisTask]):
    import multiprocessing as mp

    chunks: List[List[SynthesisTask]] = [[] for _ in range(cfg.workers)]
    for i, t in enumerate(tasks):
        chunks[i % cfg.workers].append(t)
    cfg_dict = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    ctx = mp.get_context("spawn")
    procs = []
    for wid, chunk in enumerate(chunks):
        p = ctx.Process(target=_process_worker,
                        args=(wid, cfg_dict, [t.__dict__ for t in chunk]))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
    out = Path(cfg.out_dir)
    with open(out / "manifest.jsonl", "a") as f:
        for wid in range(cfg.workers):
            part = out / f"manifest.worker{wid}.jsonl"
            if part.exists():
                f.write(part.read_text())
                part.unlink()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="input JSONL")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--backend", choices=["thread", "process"], default="thread")
    p.add_argument("--mock-inference", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-accelerator-concurrency", type=int, default=1)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--spk-audio", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    cfg = PipelineConfig(
        input_jsonl=args.input, out_dir=args.out_dir, workers=args.workers,
        backend=args.backend, mock_inference=args.mock_inference,
        deterministic=args.deterministic, seed=args.seed,
        max_accel_concurrency=args.max_accelerator_concurrency, model_dir=args.model_dir,
        default_spk_audio=args.spk_audio, device=args.device)
    tasks = load_tasks(cfg.input_jsonl)
    done = load_completed(Path(cfg.out_dir) / "manifest.jsonl")
    remaining = [t for t in tasks if t.uid not in done]
    print(f">> {len(tasks)} tasks, {len(done)} already complete, {len(remaining)} to "
          f"synthesize ({cfg.backend} x{cfg.workers})", file=sys.stderr)
    t0 = time.perf_counter()
    if cfg.backend == "thread":
        run_thread_backend(cfg, remaining)
    else:
        run_process_backend(cfg, remaining)
    wall = time.perf_counter() - t0
    total_audio = 0.0
    with open(Path(cfg.out_dir) / "manifest.jsonl") as f:
        for line in f:
            try:
                total_audio += json.loads(line).get("duration_sec", 0.0)
            except json.JSONDecodeError:
                pass
    print(json.dumps({"wall_s": round(wall, 2), "audio_s": round(total_audio, 2),
                      "workers": cfg.workers, "backend": cfg.backend}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where a continuous batch's tail seconds go, on one NVIDIA GPU:

  python3 tools/continuous_tails.py

Builds the float route's full-width engine once (chip_smoke.py's
configuration: seeded random weights, max_mel_tokens 300), then serves
chip_smoke.CONT_REQUESTS concurrent POST /tts through the port's
continuous server over it at TARS_CONTINUOUS_TAIL_WORKERS 2, 1 and 0, in
turns over 2 rounds, and after each round one request alone through a
sequential server over the same engine. Each turn prints the batch's wall
seconds and audio s per wall s, and the mean and max over its requests of
each stage's seconds (s2mel, BigVGAN, latent pass), under
TARS_STAGE_SYNC=1, so that each stage's seconds hold its time on the card.
A tail runs on a tail worker's thread (0: inline on the decode thread,
which then waits), beside the decode loop, the other tail worker and the
request threads. Its s2mel is a replay of the engine's captured CFM solve
(runtime/s2mel_infer.py), one at a time under the runner's lock, so a
tail's s2mel seconds include its wait for the other worker's replay.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stages(segs):
    return ", ".join(f"{name} {statistics.mean(v):.3f} / {max(v):.3f}" for name, v in (
        ("s2mel", [r.s2mel_time for r in segs]), ("bigvgan", [r.bigvgan_time for r in segs]),
        ("gpt_latent", [r.gpt_forward_time for r in segs])))


def main():
    if len(sys.argv) > 1:
        raise SystemExit(f"continuous_tails: takes no arguments, got {sys.argv[1:]}")
    card = cs.environment()

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        wav_path = os.path.join(tmp, "speaker.wav")
        cs.speaker_wav(wav_path)
        os.environ["TARS_MAX_MEL_TOKENS"] = str(cs.MAX_MEL_TOKENS)
        os.environ["TARS_STAGE_SYNC"] = "1"
        os.environ["TARS_CACHE_DIR"] = os.path.join(tmp, "cache")
        port = free_port()
        sequential, engine = serve.build(["--host", "127.0.0.1", "--port", str(port),
                                          "--reference-audio", wav_path], cfg=load_config())
        results = {}
        finish = engine._finish_from_codes

        def record(spk, emovec, text_ids, codes, seed, *rest):
            results[seed] = finish(spk, emovec, text_ids, codes, seed, *rest)
            return results[seed]

        engine._finish_from_codes = record
        seq_thread = cs.ServerThread(sequential)
        seed = 0
        try:
            for rnd in range(2):
                for workers in (2, 1, 0):
                    os.environ["TARS_MAX_CONCURRENCY"] = str(cs.CONT_REQUESTS)
                    os.environ["TARS_CONTINUOUS_TAIL_WORKERS"] = str(workers)
                    cport = free_port()
                    try:
                        server, _ = serve.build(["--host", "127.0.0.1", "--port", str(cport),
                                                 "--reference-audio", wav_path], engine=engine)
                    finally:
                        del os.environ["TARS_MAX_CONCURRENCY"]
                        del os.environ["TARS_CONTINUOUS_TAIL_WORKERS"]
                    thread = cs.ServerThread(server)
                    payloads = [{"text": cs.request_text(i), "seed": seed + i}
                                for i in range(cs.CONT_REQUESTS)]
                    seed += cs.CONT_REQUESTS
                    try:
                        wall, walls, audio = cs.post_batch(cport, payloads, "float",
                                                           "continuous", results)
                    finally:
                        thread.stop()
                        server.service.shutdown()
                    segs = [results[p["seed"]] for p in payloads]
                    print(f"round {rnd}, {workers} tail workers ({card}): {len(payloads)} "
                          f"requests, wall {wall:.3f} s, audio_s_per_wall_s {audio / wall:.3f}, "
                          f"request wall p50 {statistics.median(walls):.3f} max "
                          f"{max(walls):.3f}; stages_s mean / max: {stages(segs)}")
                wall, _, audio = cs.post_batch(port, [{"text": cs.request_text(0), "seed": seed}],
                                               "float", "sequential", results)
                print(f"round {rnd}, one request alone, sequential ({card}): wall {wall:.3f} s, "
                      f"stages_s: {stages([results[seed]])}")
                seed += 1
        finally:
            seq_thread.stop()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()

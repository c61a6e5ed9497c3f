#!/usr/bin/env python
"""Serving soak gate on the port: sustained request load against the TARS
server with leak and latency-drift detection.

Counterpart of tools/soak_server.py, with its flags (plus --device), its
environment defaults and its gates. It boots the port's server in-process
(`serve.main` on a thread; TARS_CHECKPOINT_DIR points it at a checkpoint
directory, else it runs seeded random weights), fires `--requests` total
requests from `--clients` concurrent clients in `--waves` equal waves,
samples host RSS, device memory (the CUDA caching allocator's bytes in
use, `utils/obs.py` `get_hbm_usage`) and the engine's captured CUDA graphs
between waves, and fails (exit 1) if:

  - host RSS grows more than --max-rss-growth-mb between the first and
    last wave (steady-state leak),
  - device memory in use grows more than 5 % from the first wave to the
    last,
  - p50 latency of the last wave exceeds --max-latency-drift x the first
    wave's (scheduler/cache degradation).

Each capture of a new bucket keeps its graph's memory pool on the card, so
every wave line also carries the number of captured graphs: growth with a
new key is a capture, growth without one a leak.

  python -m indextts_tpu_torch.tools.soak_server --requests 24 --clients 4 --waves 3
  python -m indextts_tpu_torch.tools.soak_server --device cpu ...   # no card

Each request gets a unique seed (the response cache never hits) and
rotates text so bucket reuse matches production traffic. One JSON line on
stdout; a line a wave on stderr; --output writes the full per-wave table.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def one_request(port, text, seed, timeout=600):
    payload = json.dumps({"text": text, "seed": seed}).encode()
    t0 = time.perf_counter()
    while True:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("POST", "/tts", body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            if resp.status == 429:
                time.sleep(0.2)
                t0 = time.perf_counter()
                continue
            assert resp.status == 200, (resp.status, resp.read()[:200])
            resp.read()
            return time.perf_counter() - t0
        finally:
            conn.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=60, help="total requests")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--waves", type=int, default=6)
    ap.add_argument("--port", type=int, default=18671)
    ap.add_argument("--max-rss-growth-mb", type=float, default=512.0)
    ap.add_argument("--max-latency-drift", type=float, default=1.5)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    os.environ.setdefault("TARS_MAX_CONCURRENCY", str(args.clients))
    # pin the serving mode: the server's "auto" slots default would flip to
    # continuous at clients>=4, silently changing what this soak measures;
    # soak the mode you mean (set TARS_CONTINUOUS_SLOTS yourself to soak
    # continuous)
    os.environ.setdefault("TARS_CONTINUOUS_SLOTS", "0")
    os.environ.setdefault("TARS_MAX_MEL_TOKENS", "192")
    os.environ.setdefault("TARS_KV_QUANT", "1")
    os.environ.setdefault("TARS_GPT_QUANTIZE", "1")
    os.environ.setdefault("TARS_PRECOMPILE", "0")
    os.environ.setdefault("TARS_WARMUP", "1")
    # a fresh response-cache dir and prompt per run: a soak measures
    # synthesis, and a reused dir + repeated seeds would serve every wave
    # from disk
    work = tempfile.mkdtemp(prefix="tars_soak_")
    os.environ["TARS_CACHE_DIR"] = os.path.join(work, "cache")

    import numpy as np

    from indextts_tpu_torch.utils.audio import save_wav

    prompt_path = os.path.join(work, "soak_prompt.wav")
    save_wav(
        prompt_path,
        (np.random.default_rng(0).standard_normal(5 * 16000) * 0.1).astype(np.float32),
        16000,
    )
    os.environ["TARS_REFERENCE_AUDIO"] = prompt_path

    from indextts_tpu_torch import serve

    t_start = time.perf_counter()
    built = {}
    server_argv = ["--host", "127.0.0.1", "--port", str(args.port),
                   "--reference-audio", prompt_path]
    if args.device:
        server_argv += ["--device", args.device]
    threading.Thread(
        target=serve.main, args=(server_argv,),
        kwargs={"on_built": lambda server, engine: built.update(engine=engine)},
        daemon=True,
    ).start()
    deadline = time.time() + 3600
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", args.port, timeout=5)
            c.request("GET", "/readyz")
            ok = c.getresponse().status == 200
            c.close()
            if ok:
                break
        except OSError:
            pass
        time.sleep(2)
    else:
        raise RuntimeError("server did not become ready")
    ready_s = time.perf_counter() - t_start

    texts = [
        "A sustained serving workload must hold its latency and memory. ",
        "Wave after wave of requests should leave the process unchanged. ",
        "Steady state means flat RSS flat HBM and flat tail latency here. ",
    ]

    from indextts_tpu_torch.utils.obs import get_hbm_usage

    def captured():
        engine = built.get("engine")
        return None if engine is None else sum(engine.captured_graphs().values())

    # warm every rotated shape once before the measured waves; seeds live in
    # a space no wave can reach (wave seeds stay < waves*10_000 + 100*clients)
    for i, t in enumerate(texts):
        one_request(args.port, t[:100], 1_000_000_000 + i)
    keys_warm = captured()
    warm_s = time.perf_counter() - t_start - ready_s

    per_wave = max(1, args.requests // args.waves)
    waves = []
    seed = 0
    for w in range(args.waves):
        lat: list = []
        lock = threading.Lock()

        def worker(wid, n, base):
            for r in range(n):
                t = texts[(wid + r) % len(texts)][:100]
                d = one_request(args.port, t, base + 100 * wid + r)
                with lock:
                    lat.append(d)

        n_per_client = max(1, per_wave // args.clients)
        ths = [
            threading.Thread(target=worker, args=(c, n_per_client, seed))
            for c in range(args.clients)
        ]
        seed += 10_000
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0
        lat.sort()
        hbm = get_hbm_usage(args.device)
        waves.append({
            "wave": w,
            "n": len(lat),
            "wall_s": round(wall, 2),
            "p50_s": round(lat[len(lat) // 2], 3),
            "p95_s": round(lat[min(len(lat) - 1, int(len(lat) * 0.95))], 3),
            "rss_mb": round(rss_mb(), 1),
            "hbm_gb_in_use": round(hbm.get("gb_in_use", 0.0), 3),
            "hbm_source": hbm.get("source", "none"),
            "captured_keys": captured(),
        })
        print(json.dumps(waves[-1]), file=sys.stderr)

    first, last = waves[0], waves[-1]
    rss_growth = last["rss_mb"] - first["rss_mb"]
    # growth vs a floored baseline: a tiny (or zero) first-wave footprint
    # must not make the gate vacuous — absolute growth past 5% of
    # max(baseline, 50 MB) fails even from a zero start
    hbm_growth = (
        (last["hbm_gb_in_use"] - first["hbm_gb_in_use"])
        / max(first["hbm_gb_in_use"], 0.05)
    )
    drift = last["p50_s"] / max(first["p50_s"], 1e-9)
    ok = (
        rss_growth <= args.max_rss_growth_mb
        and hbm_growth <= 0.05
        and drift <= args.max_latency_drift
    )
    summary = {
        "metric": "soak",
        "requests": sum(w["n"] for w in waves),
        "waves": args.waves,
        "rss_growth_mb": round(rss_growth, 1),
        # the allocator's statistics on the card; "unavailable" without one
        "hbm_gauge": (first["hbm_source"] if first["hbm_source"] != "none"
                      else "unavailable"),
        "hbm_growth_frac": round(hbm_growth, 4),
        "latency_drift": round(drift, 3),
        "p50_first_s": first["p50_s"],
        "p50_last_s": last["p50_s"],
        # captured graphs after the warm requests and after the last wave:
        # a wave that grows device memory with a new key captured a bucket
        "captured_keys_warm": keys_warm,
        "captured_keys_last": last["captured_keys"],
        # seconds to a ready server (engine load, warm-up) and of the warm
        # requests
        "ready_s": round(ready_s, 1),
        "warm_s": round(warm_s, 1),
        "ok": ok,
    }
    print(json.dumps(summary))
    if args.output:
        Path(args.output).write_text(
            json.dumps({"summary": summary, "waves": waves}, indent=1) + "\n"
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

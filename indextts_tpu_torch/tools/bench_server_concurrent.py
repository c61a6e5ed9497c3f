#!/usr/bin/env python
"""Multi-client serving benchmark on the port: N concurrent HTTP clients
against the port's TARS server (full-size engine, seeded random weights),
measuring per-request TTFB p50/p95, total time, and aggregate audio-sec/s —
continuous batching (TARS_CONTINUOUS_SLOTS>1) vs sequential (reference
analog: tests/benchmark_server.py:10-45, which only measured one client).

Counterpart of tools/bench_server_concurrent.py, with its flags (plus
--device), its environment defaults and its JSON line. It runs ONE mode per
process (the engine owns the card); indextts_tpu_torch/tools/
run_server_bench.sh runs both and merges them:

  TARS_MAX_MEL_TOKENS=256 python -m indextts_tpu_torch.tools.bench_server_concurrent \
      --mode sequential --clients 4 --requests 3
  TARS_CONTINUOUS_SLOTS=4 python -m indextts_tpu_torch.tools.bench_server_concurrent \
      --mode continuous ...

The server is the port's `serve.main` on a thread, its serving mode picked
by `serve.pick_continuous_slots` from TARS_CONTINUOUS_SLOTS (this tool sets
it: the client count in continuous mode, 0 in sequential mode). Left out,
TPU-only: the XLA compile cache (JAX_COMPILE_CACHE). The speaker prompt and
the response cache live in a fresh temporary directory. Prints ONE JSON
line, which adds `device` ({name, power_limit_w}) to the JAX tool's.
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


def pct(xs, p):
    xs = sorted(xs)
    if not xs:
        return None
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[k]


def client_worker(port, cid, n_requests, results, texts, repeat_prefix,
                  endpoint="/tts/stream", segments=1, seed_base=0, quick=0):
    for r in range(n_requests):
        # repeated-prefix workload: every request shares the template head,
        # unique tail + seed (exercises text-prefix KV reuse when enabled
        # and dodges the sha256 response cache)
        # keep requests within one segment of the continuous batcher's
        # 120-token bucket (no-tokenizer mode maps bytes->tokens 1:1);
        # segments>1 tiles the sentence so the server's splitter yields that
        # many segments — separating streaming first-chunk time from total
        base = texts[(cid + r) % len(texts)]
        if repeat_prefix:
            # one long template head, tiled to the segment count, with a
            # fixed-width unique tail (so each request byte-tokenizes to the
            # same length and the warm pass covers the timed shapes exactly)
            head = (texts[0] * ((segments * 110) // len(texts[0]) + 1))
            text = head[:segments * 110 - 12] + f" v {cid % 100:02d}-{r % 100:02d}"
        else:
            text = (base * ((segments * 110) // len(base) + 1))[:segments * 110]
        # seed_base separates the stream/blocking passes' payloads so the
        # sha256 response cache never shortcuts the second pass
        body = {"text": text, "seed": seed_base + 1000 * cid + r}
        if quick and endpoint == "/tts/stream":
            body["quick_streaming_tokens"] = quick
        payload = json.dumps(body).encode()
        t0 = time.perf_counter()
        ttfb = None
        nbytes = 0
        for attempt in range(200):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                conn.request("POST", endpoint, body=payload,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status == 429:
                    conn.close()
                    time.sleep(0.2)
                    t0 = time.perf_counter()  # queueing, not serving, time
                    continue
                if resp.status != 200:
                    raise RuntimeError(f"{endpoint}: HTTP {resp.status} {resp.read()[:200]!r}")
                while True:
                    # read1 returns as soon as any data arrives; a plain
                    # read(n) on a chunked response would wait for n bytes
                    # or the end, turning TTFB into total time
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    if ttfb is None:
                        ttfb = time.perf_counter() - t0
                    nbytes += len(chunk)
                break
            finally:
                conn.close()
        total = time.perf_counter() - t0
        results.append({"client": cid, "ttfb": ttfb, "total": total,
                        "audio_s": nbytes / 2.0 / 22050.0})


TEXTS = [
    "The quick brown fox jumps over the lazy dog and keeps running "
    "through the quiet evening field toward the distant river. " * 2,
    "Production text to speech serving must hold its latency targets "
    "while many clients stream audio at the same time from one chip. " * 2,
    "Weather today is mild with a gentle northern breeze and a clear "
    "sky expected to last until late in the afternoon hours. " * 2,
    "Please remain on the line while we connect you with the next "
    "available representative who can handle your billing request. " * 2,
]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m indextts_tpu_torch.tools.bench_server_concurrent")
    ap.add_argument("--mode", choices=["sequential", "continuous"], required=True)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--port", type=int, default=18652)
    ap.add_argument("--repeat-prefix", action="store_true",
                    help="all requests share one long text prefix")
    ap.add_argument("--segments", type=int, default=1,
                    help="segments per request (>1 separates streaming TTFB from total: "
                         "first chunk yields while later segments decode)")
    ap.add_argument("--blocking-pass", action="store_true",
                    help="also time a POST /tts pass for the streaming-vs-blocking TTFB "
                         "comparison")
    ap.add_argument("--quick", type=int, default=0,
                    help="also time a streaming pass with quick_streaming_tokens=N (small "
                         "early segments; first-chunk latency lever)")
    ap.add_argument("--device", default=None,
                    help="torch device of the server (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    # the server's environment (serve.main reads it): the serving mode and
    # admission, TARS_MAX_MEL_TOKENS 256, W8 + int8 KV, no precompile, a
    # warm-up
    if args.mode == "continuous":
        os.environ.setdefault("TARS_CONTINUOUS_SLOTS", str(args.clients))
    else:
        # explicit 0: the server's "auto" default would flip a sequential
        # measurement at clients >= 4 into continuous mode
        os.environ["TARS_CONTINUOUS_SLOTS"] = "0"
    os.environ.setdefault("TARS_MAX_CONCURRENCY", str(args.clients))
    os.environ.setdefault("TARS_MAX_MEL_TOKENS", "256")
    os.environ.setdefault("TARS_KV_QUANT", "1")
    os.environ.setdefault("TARS_GPT_QUANTIZE", "1")
    os.environ.setdefault("TARS_PRECOMPILE", "0")
    os.environ.setdefault("TARS_WARMUP", "1")
    # a fresh response cache per run: payloads are deterministic, so any
    # persisted cache would serve the blocking pass from disk
    work = tempfile.mkdtemp(prefix=f"tars_bench_{args.mode}_")
    os.environ["TARS_CACHE_DIR"] = os.path.join(work, "cache")

    import numpy as np

    from indextts_tpu_torch.utils.audio import save_wav

    prompt_path = os.path.join(work, "bench_server_prompt.wav")
    save_wav(prompt_path,
             (np.random.default_rng(0).standard_normal(5 * 16000) * 0.1).astype(np.float32),
             16000)
    os.environ["TARS_REFERENCE_AUDIO"] = prompt_path

    from indextts_tpu_torch import serve
    from indextts_tpu_torch.utils.device import card_info, resolve_device

    device = resolve_device(args.device)
    server_argv = ["--host", "127.0.0.1", "--port", str(args.port),
                   "--reference-audio", prompt_path]
    if args.device:
        server_argv += ["--device", args.device]
    failed = []

    def run_server():
        try:
            serve.main(server_argv)
        except BaseException as e:  # the waiting loop below reports it
            failed.append(e)
            raise

    threading.Thread(target=run_server, daemon=True).start()

    # wait for readiness (model build + warm-up synthesis incl. captures)
    deadline = time.time() + 3600
    while time.time() < deadline and not failed:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", args.port, timeout=5)
            conn.request("GET", "/readyz")
            ok = conn.getresponse().status == 200
            conn.close()
            if ok:
                break
        except OSError:
            pass
        time.sleep(2)
    else:
        raise RuntimeError(f"server did not become ready: {failed}")

    def timed_pass(endpoint, seed_base=0, quick=0):
        results: list = []
        t0 = time.perf_counter()
        threads = [
            threading.Thread(target=client_worker,
                             args=(args.port, c, args.requests, results, TEXTS,
                                   args.repeat_prefix, endpoint, args.segments, seed_base,
                                   quick))
            for c in range(args.clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if len(results) != args.clients * args.requests:
            raise RuntimeError(f"{endpoint}: {len(results)} of "
                               f"{args.clients * args.requests} requests answered")
        ttfbs = [r["ttfb"] for r in results if r["ttfb"] is not None]
        totals = [r["total"] for r in results]
        audio = sum(r["audio_s"] for r in results)
        return {
            "wall_s": round(wall, 2),
            "aggregate_audio_s": round(audio, 2),
            "aggregate_audio_s_per_s": round(audio / wall, 2),
            "ttfb_p50_s": round(pct(ttfbs, 50), 3) if ttfbs else None,
            "ttfb_p95_s": round(pct(ttfbs, 95), 3) if ttfbs else None,
            "total_p50_s": round(pct(totals, 50), 3),
            "total_p95_s": round(pct(totals, 95), 3),
            "n_results": len(results),
        }

    # one warm client pass per endpoint so every request shape is captured
    # before timing (the /tts path runs shapes the stream path does not)
    warm: list = []
    client_worker(args.port, 99, 1, warm, TEXTS, args.repeat_prefix, segments=args.segments)
    print(f"warm request: {warm[0]['total']:.2f}s audio={warm[0]['audio_s']:.2f}s",
          file=sys.stderr)
    if args.blocking_pass:
        warm_b: list = []
        client_worker(args.port, 98, 1, warm_b, TEXTS, args.repeat_prefix, endpoint="/tts",
                      segments=args.segments, seed_base=600000)
        print(f"warm blocking request: {warm_b[0]['total']:.2f}s", file=sys.stderr)

    out = {
        "mode": args.mode,
        "clients": args.clients,
        "requests_per_client": args.requests,
        "repeat_prefix": bool(args.repeat_prefix),
        "segments": args.segments,
        **timed_pass("/tts/stream"),
    }
    if args.blocking_pass:
        out["blocking"] = timed_pass("/tts", seed_base=500000)
        if out["ttfb_p50_s"] and out["blocking"]["total_p50_s"]:
            out["stream_ttfb_vs_blocking_total"] = round(
                out["ttfb_p50_s"] / out["blocking"]["total_p50_s"], 3)
    if args.quick:
        # warm the quick segmentation's shapes once, then time
        warm_q: list = []
        client_worker(args.port, 97, 1, warm_q, TEXTS, args.repeat_prefix,
                      segments=args.segments, seed_base=700000, quick=args.quick)
        out["quick_stream"] = {"quick_streaming_tokens": args.quick,
                               **timed_pass("/tts/stream", seed_base=800000, quick=args.quick)}
    out["device"] = card_info(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

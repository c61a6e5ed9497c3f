"""Live-server smoke test: the counterpart of the JAX package's
tools/run_server_test.py, through the port's client (client.py
`TTSClient`).

  python -m indextts_tpu_torch.tools.run_server_test --url http://127.0.0.1:8000

Checks /healthz and /readyz, then POST /tts (a WAV, written to
server_test.wav in the current directory) and POST /tts/stream (s16le PCM,
server_test.pcm), printing a line each. Exits 0 if all passed, else 1.
"""

from __future__ import annotations

import argparse
import sys

from indextts_tpu_torch.client import TTSClient


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("--text", default="Server smoke test, one two three.")
    p.add_argument("--spk-audio", default=None)
    args = p.parse_args(argv)

    c = TTSClient(args.url)
    print(f"healthz: {'ok' if c.healthz() else 'FAIL'}")
    print(f"readyz:  {'ok' if c.readyz() else 'FAIL'}")
    ok = c.healthz() and c.readyz()
    kw = {"spk_audio": args.spk_audio} if args.spk_audio else {}
    try:
        r = c.tts(args.text, "server_test.wav", **kw)
        with open("server_test.wav", "rb") as f:
            if f.read(4) != b"RIFF":
                raise ValueError("the answer is not a WAV")
        print(f"/tts: ok ({r['bytes']} bytes, {r['wall_s']}s)")
    except Exception as e:  # the tool reports every failure as a FAIL line
        print(f"/tts: FAIL ({e})")
        ok = False
    try:
        r = c.tts_stream(args.text, "server_test.pcm", **kw)
        print(f"/tts/stream: ok ({r['bytes']} bytes, ttfb {r['ttfb_s']}s)")
    except Exception as e:
        print(f"/tts/stream: FAIL ({e})")
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

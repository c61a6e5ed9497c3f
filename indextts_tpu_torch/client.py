"""TTS HTTP client + interactive REPL (reference: client_tts.py), for the
port's server (serve.py) or the JAX package's: the JAX package's client.py,
standard library only.

  python -m indextts_tpu_torch.client --url http://host:8000 "text"         # one-shot
  python -m indextts_tpu_torch.client --url http://host:8000 --interactive  # REPL
  python -m indextts_tpu_torch.client --test                                # smoke
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional


class TTSClient:
    def __init__(self, url: str = "http://127.0.0.1:8000", timeout: float = 300.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict):
        req = urllib.request.Request(
            f"{self.url}{path}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    def healthz(self) -> bool:
        try:
            r = urllib.request.urlopen(f"{self.url}/healthz", timeout=5)
            return r.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def readyz(self) -> bool:
        try:
            r = urllib.request.urlopen(f"{self.url}/readyz", timeout=5)
            return r.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def tts(self, text: str, out_path: str = "out.wav", **kw) -> dict:
        t0 = time.perf_counter()
        r = self._post("/tts", {"text": text, **kw})
        data = r.read()
        with open(out_path, "wb") as f:
            f.write(data)
        return {
            "path": out_path,
            "bytes": len(data),
            "wall_s": round(time.perf_counter() - t0, 3),
            "server_time": r.headers.get("X-Generation-Time"),
        }

    def tts_stream(self, text: str, out_path: str = "out.pcm", **kw) -> dict:
        t0 = time.perf_counter()
        r = self._post("/tts/stream", {"text": text, **kw})
        ttfb = None
        n = 0
        with open(out_path, "wb") as f:
            while True:
                # read1 returns as soon as any data arrives; a plain
                # read(n) on a chunked response waits for n bytes and
                # inflates the measured TTFB
                chunk = r.read1(65536)
                if not chunk:
                    break
                if ttfb is None:
                    ttfb = time.perf_counter() - t0
                f.write(chunk)
                n += len(chunk)
        return {
            "path": out_path,
            "bytes": n,
            "ttfb_s": round(ttfb or 0.0, 3),
            "wall_s": round(time.perf_counter() - t0, 3),
        }


def interactive(client: TTSClient, spk_audio: Optional[str]):
    print("IndexTTS REPL — type text, :q to quit, :spk <path> to set prompt")
    i = 0
    while True:
        try:
            line = input("tts> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line == ":q":
            break
        if line.startswith(":spk "):
            spk_audio = line[5:].strip()
            print(f"speaker prompt = {spk_audio}")
            continue
        kw = {"spk_audio": spk_audio} if spk_audio else {}
        try:
            out = client.tts(line, out_path=f"repl_{i:03d}.wav", **kw)
            print(f"  -> {out['path']} ({out['bytes']} bytes, {out['wall_s']}s)")
            i += 1
        except urllib.error.HTTPError as e:
            print(f"  !! HTTP {e.code}: {e.read().decode()[:200]}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("--url", default="http://127.0.0.1:8000")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--spk-audio", default=None)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--test", action="store_true", help="health + one synthesis")
    p.add_argument("--play", action="store_true",
                   help="play the result (first available of aplay/paplay/"
                        "afplay/ffplay; reference client_tts.py plays via "
                        "sounddevice)")
    args = p.parse_args(argv)

    c = TTSClient(args.url)
    if args.test:
        ok = c.healthz() and c.readyz()
        print(f"health: {'ok' if ok else 'FAIL'}")
        if ok and args.text:
            print(c.tts(args.text, args.output))
        sys.exit(0 if ok else 1)
    if args.interactive:
        interactive(c, args.spk_audio)
        return
    if not args.text:
        p.error("text required (or --interactive/--test)")
    kw = {"spk_audio": args.spk_audio} if args.spk_audio else {}
    if args.stream:
        print(c.tts_stream(args.text, args.output, **kw))
    else:
        print(c.tts(args.text, args.output, **kw))
    if args.play:
        play_wav(args.output)


def play_wav(path: str) -> bool:
    """Best-effort local playback through whichever CLI player exists."""
    import shutil
    import subprocess

    for cmd in (["aplay", path], ["paplay", path], ["afplay", path],
                ["ffplay", "-nodisp", "-autoexit", "-loglevel", "error", path]):
        if shutil.which(cmd[0]):
            return subprocess.call(cmd) == 0
    print(f"no audio player found (tried aplay/paplay/afplay/ffplay); "
          f"saved at {path}", file=sys.stderr)
    return False


if __name__ == "__main__":
    main()

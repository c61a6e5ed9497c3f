"""The port's environment check and live-server smoke tool
(indextts_tpu_torch/tools/env_check.py, run_server_test.py) on the CPU,
against the JAX package's tools/env_check.py and tools/run_server_test.py:

* env_check --device cpu exits 0 with every key of its report and the
  matmul check ok; without a card and without --device cpu it exits 1; on a
  card whose kernel library does not build it exits 1 and names the kernel
  (the card's calls stubbed, no kernel launched);
* run_server_test prints the JAX tool's lines (numbers aside) and gives its
  exit code, against the port's server over a stub engine
  (tests/test_torch_client.py `stub_server`) and against no server.
"""

import json
import re
import sys
from pathlib import Path

import pytest
import torch

from test_torch_client import stub_server, wait_idle

REPO = Path(__file__).resolve().parent.parent
KEYS = {"torch", "cuda_built", "device", "cuda_available", "device_count", "nvidia_smi",
        "nvcc", "gxx", "kernels", "native_dsp", "numpy", "scipy", "einops", "triton",
        "matmul_check", "failures", "ok"}


def _report(capsys, argv):
    from indextts_tpu_torch.tools import env_check

    rc = env_check.main(argv)
    return rc, json.loads(capsys.readouterr().out)


def test_env_check_cpu(capsys):
    rc, out = _report(capsys, ["--device", "cpu"])
    assert rc == 0 and out["ok"] is True and out["failures"] == []
    assert set(out) == KEYS
    assert out["torch"] == torch.__version__ and out["device"] == "cpu"
    assert out["matmul_check"] == "ok" and out["kernels"] is None
    assert out["native_dsp"] == "ok" and out["numpy"] and out["scipy"]


def test_env_check_without_a_card_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _report(capsys, [])
    assert rc == 1 and out["ok"] is False and "matmul_check" not in out
    assert any("no CUDA device" in f for f in out["failures"])


def test_env_check_names_a_kernel_that_does_not_build(capsys, monkeypatch):
    from indextts_tpu_torch.ops import cuda_lib

    def load(name):
        if name == "snake":
            raise RuntimeError("kernel build failed: stub")
        return object()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stub card")
    monkeypatch.setattr(cuda_lib, "load", load)
    rc, out = _report(capsys, [])
    assert rc == 1 and out["failures"] == ["kernel snake did not build or load"]
    assert out["kernels"] == {name: "ok" if name != "snake" else
                              "error: kernel build failed: stub" for name in cuda_lib.SOURCES}
    assert out["device_name"] == "stub card" and "matmul_check" not in out


def _masked(text: str) -> list:
    """The lines with their numbers taken out."""
    return [re.sub(r"[0-9.]+", "N", line) for line in text.splitlines()]


def _jax_tool():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import run_server_test
    finally:
        sys.path.remove(str(REPO / "tools"))
    return run_server_test


def test_run_server_test_prints_the_jax_tools_lines(tmp_path, monkeypatch, capsys):
    from indextts_tpu_torch.tools import run_server_test

    jax_tool = _jax_tool()
    monkeypatch.chdir(tmp_path)
    with stub_server(tmp_path / "cache") as (url, srv):
        rc = run_server_test.main(["--url", url])
        port = capsys.readouterr().out
        wav, pcm = (tmp_path / "server_test.wav").read_bytes(), (
            tmp_path / "server_test.pcm").read_bytes()
        wait_idle(srv)
        with pytest.raises(SystemExit) as exc:
            jax_tool.main(["--url", url])
        jax = capsys.readouterr().out
    assert rc == exc.value.code == 0
    assert _masked(port) == _masked(jax) and len(port.splitlines()) == 4
    assert port.splitlines()[:2] == ["healthz: ok", "readyz:  ok"]
    assert f"/tts: ok ({len(wav)} bytes" in port and wav[:4] == b"RIFF"
    assert f"/tts/stream: ok ({len(pcm)} bytes" in port and len(pcm) == 3 * 2048


def test_run_server_test_without_a_server(tmp_path, monkeypatch, capsys):
    """No server at the URL: FAIL on every line and exit 1, as the JAX tool."""
    from indextts_tpu_torch.tools import run_server_test

    monkeypatch.chdir(tmp_path)
    url = "http://127.0.0.1:9"
    rc = run_server_test.main(["--url", url])
    port = capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        _jax_tool().main(["--url", url])
    jax = capsys.readouterr().out
    assert rc == exc.value.code == 1
    assert [line.split(" (")[0] for line in port.splitlines()] == [
        line.split(" (")[0] for line in jax.splitlines()] == [
        "healthz: FAIL", "readyz:  FAIL", "/tts: FAIL", "/tts/stream: FAIL"]

"""The port's measurement tools (indextts_tpu_torch/bench.py and
indextts_tpu_torch/tools/benchmark_infer.py, bench_server_concurrent.py,
bench_s2mel.py, bench_w4.py, bench_decode_kernels.py) on the CPU at the
tiny size, against the JAX package's tools.

1. The bench measures what bench.py measures: its RuntimeConfig equals the
   one bench.py's own expression builds (read from bench.py's source), for
   BENCH_QUANT 0/1 x BENCH_WBITS 4/8; its tiny config equals
   tests/test_engine_e2e.py's; its prompt and text ids equal bench.py's
   draws, bit for bit.
2. At the tiny config with converted weights, the bench's request decodes
   exactly BENCH_MEL_TOKENS codes in both packages, and its duration_sec
   (the headline's numerator) is equal in both, one segment and batched.
3. `BENCH_TINY=1 python -m indextts_tpu_torch.bench` in subprocesses
   (tests/test_bench_selftest.py's counterpart): progressive supersets,
   bench.py's headline keys plus `device`, every section with a large
   budget, the skips with a small one, and a section or a warm-up that
   raises named in `sections_failed` with exit 1.
4. benchmark_infer's artifact has the JAX tool's keys, on a 2-case file.
5. bench_server_concurrent's client worker against a stub of the port's
   server (tests/test_bench_server_tool.py's counterpart), its main's JSON
   line, and the two shell scripts' merge.
6. The argument and shape parsing of bench_s2mel, bench_w4 and
   bench_decode_kernels equal the JAX tools'; each runs at the tiny config.
"""

import ast
import asyncio
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indextts_tpu.config import IndexTTS2Config as JConfig
from indextts_tpu.config import RuntimeConfig as JRuntimeConfig
from indextts_tpu.runtime.decode import GPTDecoder as JDecoder
from indextts_tpu.runtime.decode import SamplingConfig as JSampling
from indextts_tpu.runtime.engine import IndexTTS2Engine as JEngine
from indextts_tpu_torch import bench
from indextts_tpu_torch.tools import bench_decode_kernels as p_dk
from indextts_tpu_torch.tools import bench_s2mel as p_s2mel
from indextts_tpu_torch.tools import bench_server_concurrent as p_bsc
from indextts_tpu_torch.tools import bench_w4 as p_w4
from indextts_tpu_torch.tools import benchmark_infer as p_bi
from indextts_tpu_torch.utils.audio import save_wav
from indextts_tpu_torch.weights import from_jax_params
from test_engine_e2e import tiny_config
from torch_parity import parity_params, to_port_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


# ---------------------------------------------------------------------------
# Reading the JAX tools' own expressions from their sources
# ---------------------------------------------------------------------------


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text())


def _main_body(path: Path):
    return next(n for n in _tree(path).body
                if isinstance(n, ast.FunctionDef) and n.name == "main").body


def _assigned(body, names, ns):
    """Evaluate, in order, the top-level assignments of `body` to `names`
    in the namespace `ns` (updated and returned)."""
    for node in body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in names:
            ns[node.targets[0].id] = eval(compile(ast.Expression(node.value), "<jax tool>",
                                                  "eval"), ns)
    return ns


def _dict_keys(path: Path, name: str):
    """The string keys of the dict literals assigned to `name` anywhere in
    the source."""
    keys = []
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets) and isinstance(
                node.value, ast.Dict):
            keys += [k.value for k in node.value.keys if isinstance(k, ast.Constant)]
    return keys


def _returned_keys(path: Path, func: str):
    """The string keys of the dict literal that function `func` returns."""
    fn = next(n for n in ast.walk(_tree(path))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys if isinstance(k, ast.Constant)]


def _fake_os(env):
    return types.SimpleNamespace(environ=dict(env), path=os.path)


# ---------------------------------------------------------------------------
# 1. The bench's setup equals bench.py's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wbits", ["4", "8"])
@pytest.mark.parametrize("quant", ["0", "1"])
def test_bench_setup_matches_jax(quant, wbits):
    env = {"BENCH_QUANT": quant, "BENCH_WBITS": wbits}
    body = _main_body(REPO / "bench.py")
    ns = _assigned(body, {"quant", "fast_dt", "runtime"},
                   {"os": _fake_os(env), "RuntimeConfig": JRuntimeConfig})
    assert bench.bench_runtime(env) == to_port_config(ns["runtime"])
    assert bench.tiny_config() == to_port_config(tiny_config())
    # bench.py's self-test config: the tiny config with its runtime, cut down
    jtiny = dataclasses.replace(tiny_config(), runtime=dataclasses.replace(
        ns["runtime"], diffusion_steps=2, s2mel_dtype="float32", voc_dtype="float32",
        kv_quant=False, gpt_quantize=False))
    assert bench.bench_config(True, env) == to_port_config(jtiny)
    assert bench.bench_config(False, env) == to_port_config(JConfig(runtime=ns["runtime"]))
    assert bench.quant_label(bench.bench_runtime(env)) == (
        "w8a8+kv8+bf16s2mel+bf16voc" if quant == "1" and wbits == "8" else
        "w4a8+kv8+bf16s2mel+bf16voc" if quant == "1" else "fp32")
    for tiny, jcfg in ((True, jtiny), (False, JConfig(runtime=ns["runtime"]))):
        draws = _assigned(body, {"rng", "sr", "prompt_arr", "n_text", "n_codes", "text"},
                          {"os": _fake_os(env), "np": np, "tiny": tiny, "cfg": jcfg})
        prompt, sr, text, n_codes = bench.bench_inputs(to_port_config(jcfg), tiny, env)
        assert sr == draws["sr"] and n_codes == draws["n_codes"]
        assert prompt.dtype == draws["prompt_arr"].dtype
        assert prompt.tobytes() == draws["prompt_arr"].tobytes()
        assert text.dtype == draws["text"].dtype and np.array_equal(text, draws["text"])
        assert len(text) == draws["n_text"]


# ---------------------------------------------------------------------------
# 2. The bench's request decodes BENCH_MEL_TOKENS codes in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bench_engines(tmp_path_factory):
    """bench.py's engine (tiny self-test config, the GPT in bfloat16, the
    stop token banned) in both packages from the same converted weights,
    and the bench's keyed prompt and inputs."""
    jcfg = dataclasses.replace(tiny_config(), runtime=dataclasses.replace(
        JRuntimeConfig(), diffusion_steps=2, kv_quant=False, gpt_quantize=False))
    pcfg = to_port_config(jcfg)
    assert pcfg == bench.bench_config(True, {"BENCH_QUANT": "0"})
    jp = parity_params(jcfg, seed=0)
    je = JEngine(jcfg, jp, gpt_dtype=jnp.bfloat16)
    je.decoder = JDecoder(je.gpt, jcfg.gpt,
                          JSampling(do_sample=True, top_k=30, ban_stop_token=True))
    pe = bench.bench_engine(pcfg, from_jax_params(jp, pcfg), "cpu")
    prompt_arr, sr, text, n_codes = bench.bench_inputs(pcfg, True, {})
    path = str(tmp_path_factory.mktemp("bench") / "bench_prompt.wav")
    save_wav(path, prompt_arr, sr)
    return je, pe, path, text, n_codes


@pytest.mark.parametrize("batched", [False, True], ids=["one_segment", "batched"])
def test_bench_request_decodes_mel_tokens_in_both(bench_engines, batched):
    je, pe, path, text, n_codes = bench_engines
    segs = [text] * (2 if batched else 1)
    kw = dict(seed=1, max_mel_tokens=n_codes, num_beams=1, do_sample=True, batched=batched)
    out_j, out_p = je.infer(path, segs, **kw), pe.infer(path, segs, **kw)
    if not batched:
        assert [s.codes_len for s in out_j["stats"]] == [n_codes]
        assert [s.codes_len for s in out_p["stats"]] == [n_codes]
    # every segment's waveform is int(codes * 1.72) frames of the vocoder's
    # hop, segments joined by 200 ms of silence
    hop = int(np.prod(pe.cfg.vocoder.upsample_rates))
    sr = pe.cfg.runtime.sampling_rate
    expected = (len(segs) * int(n_codes * 1.72) * hop + (len(segs) - 1) * int(sr * 0.2)) / sr
    assert out_p["duration_sec"] == out_j["duration_sec"] == pytest.approx(expected, abs=1e-12)


# ---------------------------------------------------------------------------
# 3. python -m indextts_tpu_torch.bench under BENCH_TINY=1
# ---------------------------------------------------------------------------


def _bench(build_dir, budget, **env):
    """Run `BENCH_TINY=1 python -m indextts_tpu_torch.bench` (BENCH_RUNS=1,
    a 2-segment batched request, one thread) with its own build directory:
    (exit code, the JSON lines, stderr)."""
    env = dict(os.environ, BENCH_TINY="1", BENCH_BUDGET_S=str(budget), BENCH_RUNS="1",
               BENCH_BATCH_E2E="2", INDEXTTS_TORCH_BUILD_DIR=str(build_dir),
               OMP_NUM_THREADS="1", **env)
    proc = subprocess.run([sys.executable, "-m", "indextts_tpu_torch.bench"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    return proc.returncode, lines, proc.stderr


class BenchRuns:
    """Three bench processes of one thread each, on two threads started
    when the module's first test starts, so that they run beside the
    in-process tests: "full" (a large budget, every section), then "skip"
    (budget 1, "full"'s build directory, so prewarmed); beside them "fail"
    (only BATCHED, with a malformed BENCH_BATCH, and a warm-up that raises
    on a malformed BENCH_WARM_WORKERS). `get(name)` waits for
    them: (exit code, the JSON lines, stderr)."""

    def __init__(self, d: Path):
        off = {f"BENCH_{s}": "0" for s in bench.SECTIONS if s != "BATCHED"}
        self.results = {}

        def full_then_skip():
            self.results["full"] = _bench(d / "build", 600)
            self.results["skip"] = _bench(d / "build", 1)

        def fail():
            self.results["fail"] = _bench(d / "build_fail", 600, BENCH_BATCH="8,x",
                                          BENCH_WARM_WORKERS="x", **off)

        self.threads = [threading.Thread(target=f, daemon=True) for f in (full_then_skip, fail)]
        for t in self.threads:
            t.start()

    def join(self):
        for t in self.threads:
            t.join(timeout=600)
            assert not t.is_alive()

    def get(self, name: str):
        self.join()
        return self.results[name]


@pytest.fixture(scope="module", autouse=True)
def bench_runs(tmp_path_factory):
    runs = BenchRuns(tmp_path_factory.mktemp("bench_runs"))
    yield runs
    runs.join()


def test_bench_emits_incremental_supersets(bench_runs):
    rc, lines, err = bench_runs.get("full")
    assert rc == 0, err[-3000:]
    assert len(lines) >= 2, "expected progressive emits"
    head = lines[0]
    jax_keys = _dict_keys(REPO / "bench.py", "result")
    assert set(head) == set(jax_keys) | {"device", "launches", "timed_stages",
                                         "codes_decoded", "sections_failed"}
    assert head["metric"] == "audio_sec_generated_per_wall_sec" and head["value"] > 0
    assert head["device"] == {"name": "cpu", "power_limit_w": None}
    assert head["launches"] == {} and head["quant"] == "fp32"
    # the bench's tokens/s is BENCH_MEL_TOKENS codes over the timed gpt_gen seconds
    timed = head["timed_stages"]
    assert set(timed) == {"gpt_gen", "gpt_fwd", "s2mel", "bigvgan"}
    assert head["tokens_per_s"] == pytest.approx(16 / timed["gpt_gen"], rel=0.05)
    assert head["codes_decoded"] == 16
    for line in lines[1:]:
        for k, v in head.items():
            assert line[k] == v, k
    last = lines[-1]
    for key in ("stages", "seq_tail", "batched_decode_tok_s", "batched_decode_tok_s_b16",
                "batched_e2e_audio_s", "batched_stages", "beam3_audio_s"):
        assert key in last, key
    assert last["seq_tail"]["segments"] == 4
    assert set(last["batched_stages"]) == {"decode", "host_trim", "latent", "s2mel", "vocoder"}
    assert last["sections_skipped"] == [] and last["sections_failed"] == []
    assert last["startup_prewarmed"] is False and last["cold_startup_s"] == head["startup_s"]


def test_bench_budget_skips_but_headline_survives(bench_runs):
    rc, lines, err = bench_runs.get("skip")
    assert rc == 0, err[-3000:]
    last = lines[-1]
    assert last["value"] > 0
    assert last["sections_skipped"] == [s.lower() for s in bench.SECTIONS]
    assert "batched_e2e_audio_s" not in last and last["sections_failed"] == []
    # the second process found the first one's libraries and cold number
    assert last["startup_prewarmed"] is True
    assert last["cold_startup_s"] == bench_runs.get("full")[1][0]["startup_s"]


def test_bench_failed_section_is_named_and_exits_nonzero(bench_runs):
    rc, lines, err = bench_runs.get("fail")
    assert rc == 1
    assert lines and lines[0]["value"] > 0
    last = lines[-1]
    assert last["sections_failed"] == ["warmup", "batched"] and last["sections_skipped"] == []
    assert "batched_decode_tok_s" not in last and "ValueError" in err


# ---------------------------------------------------------------------------
# 4. benchmark_infer's artifact
# ---------------------------------------------------------------------------


def test_benchmark_infer_artifact_has_the_jax_keys(tmp_path, monkeypatch):
    import indextts_tpu_torch.config as pconfig

    pcfg = bench.tiny_config()
    monkeypatch.setattr(pconfig, "load_config", lambda *a, **k: pcfg)
    prompt = str(tmp_path / "spk.wav")
    save_wav(prompt, bench.bench_inputs(pcfg, True, {})[0], 16000)
    cases = tmp_path / "cases.jsonl"
    cases.write_text("".join(json.dumps(c) + "\n" for c in (
        {"text": "tiny case one"}, {"text": "tiny case two", "emo_alpha": 0.6})))
    out = tmp_path / "result.json"
    p_bi.main(["--cases", str(cases), "--spk-audio", prompt, "--output", str(out),
               "--wav-dir", str(tmp_path / "wavs"), "--device", "cpu"])
    art = json.loads(out.read_text())
    src = TOOLS / "benchmark_infer.py"
    assert list(art) == _dict_keys(src, "summary")
    assert art["cases"] == 2 and len(art["results"]) == 2
    for i, row in enumerate(art["results"]):
        assert list(row) == _dict_keys(src, "row")
        assert row["case"] == i and row["audio_dur_s"] > 0 and row["hbm_peak_gb"] == 0
    assert (tmp_path / "wavs" / "case_001.wav").exists()


# ---------------------------------------------------------------------------
# 5. bench_server_concurrent against a stub of the port's server
# ---------------------------------------------------------------------------

SEG_DELAY = 0.15
TEXTS = ["the quick brown fox jumps over the lazy dog again and again " * 4]


def _stub_engine(text="", **kw):
    # the blocking route: every segment synthesized before the response
    time.sleep(SEG_DELAY * max(1, len(text) // 110))
    return {"audio": np.zeros(2205, np.float32), "sampling_rate": 22050}


def _stub_stream(text="", **kw):
    # the streaming route: one chunk a ~110-char segment as it finishes
    for _ in range(max(1, len(text) // 110)):
        time.sleep(SEG_DELAY)
        yield np.zeros(2205, np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def stub_port(tmp_path_factory):
    from indextts_tpu_torch.runtime.server import ServerSettings, TTSServer

    port = _free_port()
    srv = TTSServer(_stub_engine, ServerSettings(
        host="127.0.0.1", port=port, max_concurrency=4,
        cache_dir=str(tmp_path_factory.mktemp("cache"))), stream_fn=_stub_stream)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def start():
        return asyncio.ensure_future(srv.serve())

    async def stop(task):
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)

    task = asyncio.run_coroutine_threadsafe(start(), loop).result(timeout=30)
    t0 = time.time()
    while not srv.ready:
        assert not task.done() and time.time() - t0 < 30
        time.sleep(0.02)
    yield port
    asyncio.run_coroutine_threadsafe(stop(task), loop).result(timeout=30)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=10)
    assert not thread.is_alive()
    srv.pool.shutdown(wait=True)


def test_multisegment_text_construction(stub_port):
    results = []
    p_bsc.client_worker(stub_port, 0, 1, results, TEXTS, False, endpoint="/tts/stream",
                        segments=4)
    assert len(results) == 1
    assert results[0]["audio_s"] == pytest.approx(4 * 2205 / 22050.0, rel=0.01)


def test_stream_ttfb_separates_from_total(stub_port):
    stream_res, block_res = [], []
    p_bsc.client_worker(stub_port, 0, 2, stream_res, TEXTS, False, endpoint="/tts/stream",
                        segments=4)
    p_bsc.client_worker(stub_port, 0, 2, block_res, TEXTS, False, endpoint="/tts",
                        segments=4, seed_base=500000)
    stream_ttfb = p_bsc.pct([r["ttfb"] for r in stream_res], 50)
    blocking_total = p_bsc.pct([r["total"] for r in block_res], 50)
    assert stream_ttfb <= 0.5 * blocking_total, (stream_ttfb, blocking_total)
    assert all(r["total"] >= r["ttfb"] for r in stream_res)


def test_seed_base_dodges_response_cache(stub_port):
    first, second = [], []
    p_bsc.client_worker(stub_port, 7, 1, first, TEXTS, False, endpoint="/tts", segments=2)
    t0 = time.perf_counter()
    p_bsc.client_worker(stub_port, 7, 1, second, TEXTS, False, endpoint="/tts", segments=2,
                        seed_base=500000)
    assert time.perf_counter() - t0 >= SEG_DELAY


@pytest.fixture
def saved_env():
    """The tool sets its TARS_* defaults in os.environ: put it back."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def test_server_bench_main_line(stub_port, monkeypatch, capsys, saved_env):
    """main against the stub (serve.main patched to leave it serving):
    the JAX tool's keys plus `device`, and its environment defaults."""
    from indextts_tpu_torch import serve

    seen = {}

    def fake_main(argv):
        seen["argv"] = argv
        time.sleep(3600)  # the stub already serves on the port

    monkeypatch.setattr(serve, "main", fake_main)
    for k in ("TARS_CONTINUOUS_SLOTS", "TARS_MAX_CONCURRENCY", "TARS_MAX_MEL_TOKENS",
              "TARS_KV_QUANT", "TARS_GPT_QUANTIZE", "TARS_PRECOMPILE", "TARS_WARMUP",
              "TARS_CACHE_DIR", "TARS_REFERENCE_AUDIO"):
        os.environ.pop(k, None)
    p_bsc.main(["--mode", "sequential", "--clients", "2", "--requests", "1", "--port",
                str(stub_port), "--segments", "2", "--blocking-pass", "--quick", "20",
                "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    src = TOOLS / "bench_server_concurrent.py"
    timed = _returned_keys(src, "timed_pass")
    assert list(out) == (_dict_keys(src, "out") + timed + [
        "blocking", "stream_ttfb_vs_blocking_total", "quick_stream", "device"])
    assert out["device"] == {"name": "cpu", "power_limit_w": None}
    assert list(out["blocking"]) == timed
    assert out["n_results"] == out["blocking"]["n_results"] == 2
    assert out["quick_stream"]["quick_streaming_tokens"] == 20
    assert out["aggregate_audio_s"] == pytest.approx(2 * 2 * 2205 / 22050.0, rel=0.01)
    assert seen["argv"][-2:] == ["--device", "cpu"]
    assert {k: os.environ[k] for k in ("TARS_CONTINUOUS_SLOTS", "TARS_MAX_CONCURRENCY",
                                       "TARS_MAX_MEL_TOKENS", "TARS_KV_QUANT",
                                       "TARS_GPT_QUANTIZE", "TARS_PRECOMPILE",
                                       "TARS_WARMUP")} == {
        "TARS_CONTINUOUS_SLOTS": "0", "TARS_MAX_CONCURRENCY": "2",
        "TARS_MAX_MEL_TOKENS": "256", "TARS_KV_QUANT": "1", "TARS_GPT_QUANTIZE": "1",
        "TARS_PRECOMPILE": "0", "TARS_WARMUP": "1"}


STUB_PY = """#!{python}
import json, os, sys
if sys.argv[1] == "-m":
    print(json.dumps({{"progress": 1}}))
    print(json.dumps({{"argv": " ".join(sys.argv[1:]),
                      "slots": os.environ.get("TARS_CONTINUOUS_SLOTS"),
                      "prefix": os.environ.get("TARS_PREFIX_REUSE"),
                      "aggregate_audio_s_per_s": 2.0, "ttfb_p50_s": 1.5}}))
else:
    os.execv(sys.executable, [sys.executable] + sys.argv[1:])
"""


@pytest.mark.parametrize("script", ["run_server_bench.sh", "run_prefix_bench.sh"])
def test_run_bench_scripts_merge_the_two_runs(script, tmp_path):
    """The shell scripts run the tool twice (PYTHON, here a stub that
    prints the line the tool would, its arguments and environment in it)
    and merge the last lines into the artifact named by their argument,
    a path relative to the caller's directory."""
    stub = tmp_path / "py"
    stub.write_text(STUB_PY.format(python=sys.executable))
    stub.chmod(0o755)
    proc = subprocess.run(
        ["bash", str(REPO / "indextts_tpu_torch" / "tools" / script), "out.json",
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHON=str(stub), CLIENTS="2"))
    assert proc.returncode == 0, proc.stderr
    art = json.loads((tmp_path / "out.json").read_text())
    tool = "-m indextts_tpu_torch.tools.bench_server_concurrent"
    if script == "run_server_bench.sh":
        seq, cont = art["sequential"], art["continuous"]
        for run, mode in ((seq, "sequential"), (cont, "continuous")):
            assert run["argv"] == (f"{tool} --mode {mode} --clients 2 --requests 3 "
                                   "--segments 4 --blocking-pass --device cpu")
        assert cont["slots"] == "2" and art["speedup_aggregate"] == 1.0
    else:
        off, on = art["prefix_reuse_off"], art["prefix_reuse_on"]
        for run, port in ((off, 18655), (on, 18656)):
            assert run["argv"] == (f"{tool} --mode sequential --clients 2 --requests 4 "
                                   f"--repeat-prefix --port {port} --device cpu")
        assert (off["prefix"], on["prefix"]) == ("0", "1") and art["ttfb_p50_delta_s"] == 0.0


# ---------------------------------------------------------------------------
# 6. bench_s2mel, bench_w4 and bench_decode_kernels
# ---------------------------------------------------------------------------


def _jax_arguments(path: Path):
    """{flag: (type name, default)} of the add_argument calls in `path`."""
    out = {}
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (
                getattr(kw.get("type"), "id", None),
                ast.literal_eval(kw["default"]) if "default" in kw else None)
    return out


def test_s2mel_arguments_and_shapes_match_jax():
    ours = {a.option_strings[0]: (getattr(a.type, "__name__", None), a.default)
            for a in p_s2mel.build_parser()._actions if a.option_strings}
    ours.pop("-h")
    ours.pop("--device")
    assert ours == _jax_arguments(TOOLS / "bench_s2mel.py")
    # the JAX tool's per-shape parse, `B, T = ...; P = T // 4`
    body = next(n for n in ast.walk(_tree(TOOLS / "bench_s2mel.py"))
                if isinstance(n, ast.For)).body
    spec = ours["--shapes"][1]
    jax_shapes = []
    for shape in spec.split(","):
        ns = {"shape": shape}
        exec(compile(ast.Module(body=body[:2], type_ignores=[]), "<bench_s2mel>", "exec"),
             {}, ns)
        jax_shapes.append((ns["B"], ns["T"], ns["P"]))
    assert p_s2mel.parse_shapes(spec) == jax_shapes == [(1, 256, 64), (1, 512, 128),
                                                         (8, 512, 128)]


def test_w4_and_decode_kernel_settings_match_jax():
    w4 = _tree(TOOLS / "bench_w4.py").body
    for env in ({}, {"BENCH_W4_STEPS": "123"}):
        ns = _assigned(w4, {"MN"}, {"os": _fake_os(env)})
        assert p_w4.steps_from_env(env) == ns["MN"]
    dk = _tree(TOOLS / "bench_decode_kernels.py").body
    mn = _assigned(dk, {"MN"}, {})["MN"]
    batches = sorted({c.args[2].value for c in ast.walk(ast.Module(body=dk, type_ignores=[]))
                      if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "run"})
    args = p_dk.build_parser().parse_args([])
    assert args.steps == mn and sorted(int(b) for b in args.batches.split(",")) == batches
    # the JAX tools' decode inputs: 64 text ids below 12000 at full width
    assert p_dk.text_shape(bench.bench_config(False, {})) == (64, 12000)


def test_ab_tools_run_at_the_tiny_config(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TINY", "1")
    s2 = p_s2mel.main(["--shapes", "1x64", "--steps", "2", "--iters", "1"])
    assert set(s2) == {"1x64_bf16_ms", "1x64_fp32_ms", "device", "launches"}
    monkeypatch.setenv("BENCH_W4_STEPS", "4")
    w4 = p_w4.main([])
    assert [(r["wbits"], r["gemv_impl"], r["gemv"]) for r in w4["runs"]] == [
        (8, "xla", False), (4, "pallas", True)]
    dk = p_dk.main(["--steps", "4", "--batches", "1,2"])
    assert [(r["B"], r["gemv_impl"], r["gemv"], r["cache"]) for r in dk["runs"]] == [
        (b, impl, impl == "pallas", cache) for b in (1, 2)
        for impl, cache in (("auto", "int8"), ("pallas", "int8"), ("xla", "int8"),
                            ("auto", "float"))]
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == [s2, w4, dk]
    for run in w4["runs"] + dk["runs"]:
        assert run["tok_s"] > 0 and run["launches"] == {}

"""chip_smoke.py's comparison of a captured step's replay with an eager
step, its check that a kernel's call is one launch, bench_phase's check of
the bench's JSON lines, and parallel_phase's reading of a cut quantized
GPT's routes and of the greedy margins.

The profiler runs only on the card, so `step_kernels` and
`rng_replay_kernels` are replaced by fakes that hand out the kernel
records of one measurement each; `replay_against_eager` must measure all
three again while a difference, or a sampling step's missing generator
kernels, may come from lost records, and report a difference that stays.
"""

import pytest

import chip_smoke

FILL = "vectorized_elementwise_kernel<2, FillFunctor<long>, std::array<char*, 1ul> >(int"
STEP = {"gemv": (24, 0.5), FILL: (4, 0.01)}
REPLAY = {"gemv": (24, 0.5), FILL: (6, 0.01)}  # the step's 4 fills + the generator's 2
RNG = {FILL: 2}


class _Graph:
    def replay(self):
        pass


def _fake(monkeypatch, eager, replays, rngs):
    """step_kernels hands out `eager` for the eager step and the next of
    `replays` for a replay; rng_replay_kernels the next of `rngs`."""
    graph = _Graph()
    replays, rngs, calls = iter(replays), iter(rngs), []

    def step_kernels(fn):
        calls.append(fn)
        return dict(next(replays) if fn == graph.replay else eager)

    monkeypatch.setattr(chip_smoke, "step_kernels", step_kernels)
    monkeypatch.setattr(chip_smoke, "rng_replay_kernels", lambda: dict(next(rngs)))
    return graph, calls


@pytest.mark.parametrize("lost", ["generator fills", "replay fills"])
def test_lost_records_are_measured_again(monkeypatch, capsys, lost):
    """One try whose generator or replay measurement lost two fills (the
    refusal's (4, 6)), then one that did not: the second try's counts are
    equal, and the first try's difference is printed."""
    if lost == "generator fills":
        rngs, replays = [{}, RNG], [REPLAY, REPLAY]
    else:
        rngs, replays = [RNG, RNG], [{"gemv": (24, 0.5), FILL: (4, 0.01)}, REPLAY]
    graph, calls = _fake(monkeypatch, STEP, replays, rngs)
    eager_k, graph_k, rng, counts = chip_smoke.replay_against_eager(
        lambda: None, graph, True, "w8")
    assert counts[0] == counts[1] == {"gemv": 24, FILL: 4}
    assert rng == RNG and graph_k == REPLAY and eager_k == STEP
    assert len(calls) == 4
    assert "measured again" in capsys.readouterr().out


def test_a_difference_that_stays_is_returned(monkeypatch):
    """An extra kernel in every replay survives all tries and comes back
    in the counts, with the generator's kernels taken off the replay."""
    extra = {**REPLAY, "extra": (1, 0.001)}
    graph, calls = _fake(monkeypatch, STEP, [extra] * 5, [RNG] * 5)
    *_, counts = chip_smoke.replay_against_eager(lambda: None, graph, True, "w8", tries=5)
    assert len(calls) == 10
    assert chip_smoke.kernel_diff(counts) == {"extra": (None, 1)}


def test_a_sampling_step_needs_generator_kernels(monkeypatch):
    """A sampling graph's replay must add the generator's kernels: equal
    counts with none measured are taken as lost records and measured
    again, up to the last try."""
    graph, calls = _fake(monkeypatch, STEP, [STEP] * 3, [{}] * 3)
    *_, rng, counts = chip_smoke.replay_against_eager(lambda: None, graph, True, "w8")
    assert len(calls) == 6 and rng == {}
    assert counts[0] == counts[1]


def test_a_greedy_step_measures_no_generator(monkeypatch):
    """do_sample off: no generator is registered, and rng_replay_kernels is
    not called; equal counts end at the first try."""
    graph, calls = _fake(monkeypatch, STEP, [STEP], [])
    *_, rng, counts = chip_smoke.replay_against_eager(lambda: None, graph, False, "float")
    assert rng == {} and len(calls) == 2
    assert counts[0] == counts[1]


def test_graph_copy_node_counts_as_the_eager_memcpy(monkeypatch):
    """A graph's copy node run as the driver's memcpy32_post is the eager
    step's device-to-device memcpy."""
    memcpy = "Memcpy DtoD (Device -> Device)"
    graph, _ = _fake(monkeypatch, {**STEP, memcpy: (1, 0.001)},
                     [{**REPLAY, "memcpy32_post": (1, 0.001)}], [RNG])
    *_, counts = chip_smoke.replay_against_eager(lambda: None, graph, True, "w8")
    assert counts[0] == counts[1]


K = "dit_attn_bf16_kernel<2>"


@pytest.mark.parametrize("windows,passes", [
    ([({K: (1.0, 0.01)}, 1.0)], True),
    # device records lost in every profile, one launch call a call on the host
    ([({K: (47 / 48, 0.01)}, 1.0)] * 3, True),
    # lost, then a whole profile
    ([({K: (47 / 48, 0.01)}, 1.0), ({K: (1.0, 0.01)}, 1.0)], True),
    # lost, and the host recorded fewer launch calls than calls
    ([({K: (47 / 48, 0.01)}, 47 / 48)] * 3, False),
    # lost, and a second kernel seen
    ([({K: (0.5, 0.01), "other": (0.25, 0.001)}, 1.0)] * 3, False),
    # two kernels a call fail at once
    ([({K: (1.0, 0.01), "other": (1.0, 0.001)}, 2.0)], False),
    ([({}, 0.0)] * 3, False),
])
def test_one_launch(monkeypatch, windows, passes):
    """one_launch over profiles that hand out `windows` in turn: passes or
    fails as stated, profiling no more than it needs."""
    seen = iter(windows)
    monkeypatch.setattr(chip_smoke, "profile_calls", lambda fn: next(seen))
    if passes:
        chip_smoke.one_launch("K3-bf16", lambda: None)
    else:
        with pytest.raises(SystemExit, match="not one"):
            chip_smoke.one_launch("K3-bf16", lambda: None)
    assert next(seen, None) is None


# ---------------------------------------------------------------------------
# bench_phase's check of `python -m indextts_tpu_torch.bench`'s lines
# ---------------------------------------------------------------------------


def _bench_lines(layers=24):
    """A headline and a last line as the bench prints them on the default
    route at chip_smoke's settings."""
    runs = int(chip_smoke.BENCH_TOOLS["bench_runs"])
    codes = int(chip_smoke.BENCH_MEL_TOKENS) * runs
    head = {"value": 1.5, "tokens_per_s": round(codes / 0.4, 1), "rtf": 0.6,
            "sections_skipped": [], "sections_failed": [], "codes_decoded": codes,
            "timed_stages": {"gpt_gen": 0.4, "gpt_fwd": 0.01, "s2mel": 0.05, "bigvgan": 0.02},
            "device": {"name": "H100", "power_limit_w": 700.0},
            "launches": {"K2": 37, "K3-bf16": 260, "K4": layers * (codes // runs - 1) * runs,
                         "K5": 2401, "K6": 1176}}
    last = dict(head, batched_decode_tok_s=900.0, batched_decode_tok_s_b16=1500.0,
                batched_e2e_audio_s=10.0, beam3_audio_s=2.0,
                stages={"gpt_gen": 0.4, "gpt_fwd": 0.01, "s2mel": 0.05, "bigvgan": 0.02},
                seq_tail={"overlap": 2.0, "inline": 1.9, "segments": 4},
                batched_stages={"decode": 1.0, "host_trim": 0.0, "latent": 0.1})
    return [head, last]


@pytest.mark.parametrize("fault", [None, "codes", "tokens_per_s", "k4", "k5_missing",
                                   "k1_launched", "failed", "device"])
def test_check_bench_lines(fault):
    """The default route's line passes; one fewer decoded code, a tokens/s
    off its codes over gpt_gen, K4 off one launch a layer a step, K5 not
    launched, K1 launched, a failed section or another card fail it."""
    lines = _bench_lines()
    for line in lines:
        if fault == "codes":
            line["codes_decoded"] -= 1
        elif fault == "tokens_per_s":
            line["tokens_per_s"] *= 1.2
        elif fault == "k4":
            line["launches"] = dict(line["launches"], K4=line["launches"]["K4"] + 24)
        elif fault == "k5_missing":
            line["launches"] = {k: v for k, v in line["launches"].items() if k != "K5"}
        elif fault == "k1_launched":
            line["launches"] = dict(line["launches"], K1=10)
        elif fault == "device":
            line["device"] = {"name": "A100", "power_limit_w": 400.0}
    if fault == "failed":
        lines[-1]["sections_failed"] = ["beam"]
    if fault is None:
        assert chip_smoke.check_bench_lines(lines, "H100", "card", 24) is lines[-1]
    else:
        with pytest.raises(SystemExit):
            chip_smoke.check_bench_lines(lines, "H100", "card", 24)


def test_low_margin_step():
    """The top-2 margin is read off the logits as the greedy loop processes
    them: the repetition penalty over the fake-prompt tokens {1, start_mel}
    and the codes before the step, the stop token banned."""
    import torch
    from types import SimpleNamespace

    cfg = SimpleNamespace(gpt=SimpleNamespace(start_mel_token=8, stop_mel_token=9))
    lg = torch.zeros(3, 10)
    lg[0, 2], lg[0, 3] = 3.0, 1.0  # margin 2
    # code 2 penalized to 0.3 and the stop token banned: margin 1.0 - 0.5
    lg[1, 2], lg[1, 4], lg[1, 5], lg[1, 9] = 3.0, 1.0, 0.5, 5.0
    # start_mel penalized to 0.4: margin 1.0 - 0.95
    lg[2, 8], lg[2, 6], lg[2, 7] = 4.0, 1.0, 0.95
    codes = torch.tensor([2, 4, 6])
    assert chip_smoke.low_margin_step(lg, codes, 0.01, cfg) == 3
    assert chip_smoke.low_margin_step(lg, codes, 0.1, cfg) == 2
    assert chip_smoke.low_margin_step(lg, codes, 0.6, cfg) == 1
    assert chip_smoke.low_margin_step(lg, codes, 2.5, cfg) == 0


@pytest.mark.parametrize("wbits", [8, 4])
def test_cut_layer_routes(wbits):
    """What parallel_phase prints of a cut GPT on the GEMV kernels (D=512,
    4 heads, the int8 head, model=2): c_attn's local columns on K5 or K7,
    the W8 attn c_proj row-cut or the W4 one whole after the gather, the
    fused MLP over the rank's hidden slice in the one-process groups, the
    head's 64 local columns on the plain contraction (K5's gate closed)."""
    import dataclasses

    from indextts_tpu_torch.models.unified_voice import UnifiedVoice
    from indextts_tpu_torch.parallel.sharding import GPT_PARTITION_RULES, Mesh
    from indextts_tpu_torch.parallel.tp import tensor_parallel
    from test_torch_quant import _gpt_config
    from torch_parity import parity_config, to_port_config

    gcfg = to_port_config(dataclasses.replace(parity_config(), gpt=_gpt_config(512, 4))).gpt
    model = UnifiedVoice(gcfg, quantize=True, head_quant=True, wbits=wbits, gemv=True)
    tensor_parallel(model, Mesh(1, 2, rank=1), GPT_PARTITION_RULES)
    gemv, mlp, proj = ("K7", "K8", "GatherHeads 512x512") if wbits == 4 else (
        "K5", "K6", "RowParallel 256x512")
    assert chip_smoke.cut_layer_routes(model) == (
        f"c_attn QConv1D 512x768 {gemv}; attn c_proj {proj} {gemv}; MLP {mlp} over 1024 "
        f"hidden columns in groups of 1024; head GatherColumns 512x64 plain")

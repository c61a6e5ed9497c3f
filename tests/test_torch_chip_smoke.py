"""chip_smoke.py's comparison of a captured step's replay with an eager
step, and its check that a kernel's call is one launch.

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

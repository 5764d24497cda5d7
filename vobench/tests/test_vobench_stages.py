"""The stage readers (vobench/stages.py, vobench/metrics/*_device_ms.fleet)
on hand-made traced slices: the stamps' starts bound each stage, the
stages add up to the replay, and a trace without stamps (a program that
has none), with another number of them than six a step, or no trace at
all gives nothing.  Also the window's summary of `vobench.stage_window`
and the idle breakdown's labels under the program's host spans."""

import numpy as np
import pytest

from vobench import registry
from vobench.run import Readings
from vobench.stages import NAMES, STAMP, breakdown
from vobench.trace import Event, TraceSummary

STAGES = ("points", "lines", "f2f", "optimizer", "keyframe")
# per replay: the stamps' offsets from its start, us
OFFSETS = (0.0, 40_000.0, 120_000.0, 135_000.0, 190_000.0, 192_000.0)
STARTS = (1_000.0, 300_000.0, 600_000.0)
STAMP_NAME = STAMP + "(long long*, long long*, int, int, int, int)"


def _trace(starts=STARTS, offsets=OFFSETS, extra=()):
    """A traced slice: per replay its six stamps (1 us each), one kernel
    of 500 us inside each stage, and a copy-in kernel before it."""
    kernels = []
    for t0 in starts:
        kernels.append(Event("index_select_kernel", t0 - 50.0, 20.0))
        for k, off in enumerate(offsets):
            kernels.append(Event(STAMP_NAME, t0 + off, 1.0))
            if k:
                kernels.append(Event(f"stage{k}_kernel",
                                     t0 + offsets[k - 1] + 10.0, 500.0))
    kernels += list(extra)
    kernels.sort(key=lambda e: e.ts)
    return TraceSummary(device=kernels, kernels=kernels, spans=[],
                        window=(0.0, STARTS[-1] + 300_000.0))


def _readings(trace, steps):
    return Readings(vo={}, cam={}, lanes=64, trace=trace, steps_traced=steps,
                    graph_nodes=None, step_host_ms=[], refine_s=[])


def _read(metric, r):
    return registry.reader(metric).read(r)


def test_each_stage_is_read_between_its_stamps():
    r = _readings(_trace(), 3)
    want = np.diff(OFFSETS) * 1e-3
    got = [_read(f"{s}_device_ms.fleet", r) for s in STAGES]
    np.testing.assert_allclose(got, want)
    assert sum(got) == pytest.approx(OFFSETS[-1] * 1e-3)


def test_stage_means_over_replays_of_other_lengths(capsys):
    """A replay whose optimizer runs 9 ms longer moves that stage's mean
    by a third of it and no other; the points reader prints the breakdown
    to standard error, one line a stage."""
    slow = OFFSETS[:4] + tuple(o + 9_000.0 for o in OFFSETS[4:])
    kernels = [e for e in _trace().kernels if e.ts < STARTS[-1] - 100.0]
    last = _trace(starts=STARTS[-1:], offsets=slow).kernels
    r = _readings(TraceSummary(device=kernels + last, kernels=kernels + last,
                               spans=[], window=(0.0, 1e6)), 3)
    want = np.diff(OFFSETS) * 1e-3
    want[3] += 3.0
    got = [_read(f"{s}_device_ms.fleet", r) for s in STAGES]
    np.testing.assert_allclose(got, want)
    err = capsys.readouterr().err
    assert all(f"stage {s}:" in err for s in STAGES + ("outside",))


def test_breakdown_counts_the_kernels_of_each_stage():
    rows = {name: rest for name, *rest in breakdown(_readings(_trace(), 3))}
    for k, s in enumerate(STAGES, start=1):
        kernels, wall, busy, top = rows[s]
        assert kernels == 1.0 and busy == pytest.approx(0.5)
        assert wall == pytest.approx((OFFSETS[k] - OFFSETS[k - 1]) * 1e-3)
        assert top == [(f"stage{k}_kernel", pytest.approx(0.5))]
    kernels, wall, busy, _ = rows["outside"]
    assert kernels == 1.0 and busy == pytest.approx(0.02)


@pytest.mark.parametrize("case", ["no_trace", "no_steps", "no_stamps",
                                  "a_stamp_short"])
def test_nothing_to_read_gives_none(case, capsys):
    trace, steps = _trace(), 3
    if case == "no_trace":
        trace = None
    elif case == "no_steps":
        steps = 0
    elif case == "no_stamps":        # the program before it had stamps
        ks = [e for e in trace.kernels if STAMP not in e.name]
        trace = trace._replace(kernels=ks, device=ks)
    else:
        ks = trace.kernels[:-1]
        assert STAMP in trace.kernels[-1].name
        trace = trace._replace(kernels=ks, device=ks)
    r = _readings(trace, steps)
    for s in STAGES:
        assert _read(f"{s}_device_ms.fleet", r) is None
    assert breakdown(r) is None
    said = capsys.readouterr().err
    assert ("expected" in said) == (case == "a_stamp_short")
    assert "kernels/step" not in said


def test_the_stamps_are_named_as_the_program_stamps():
    assert NAMES == ("begin",) + STAGES
    assert all(STAMP not in k for mod in registry.roofline_modules()
               for k in mod.KERNELS)
    assert all(k not in STAMP for mod in registry.roofline_modules()
               for k in mod.KERNELS)


def test_window_summary_of_the_ring_rows():
    """`stage_window.summary`: each stage's mean over all rows, the first
    and the last `EDGE`, and the replays' ms, from rows of nanoseconds."""
    from vobench.stage_window import EDGE, summary

    names = ["begin"] + list(STAGES)
    n = 2 * EDGE + 8
    base = np.cumsum([0.0] + list(np.diff(OFFSETS) * 1e3))     # ns
    rows = np.array([base + i * 1e9 for i in range(n)], dtype=np.int64)
    rows[:EDGE, 4:] += 2_000_000           # the first EDGE: optimizer +2 ms
    out = summary(names, rows)
    step = np.diff(OFFSETS) * 1e-3
    assert out["rows"] == n and len(out["replay_ms"]) == n
    assert out["first_stage_ms"]["optimizer"] == pytest.approx(step[3] + 2.0)
    assert out["last_stage_ms"]["optimizer"] == pytest.approx(step[3])
    assert out["stage_ms"]["optimizer"] == pytest.approx(
        step[3] + 2.0 * EDGE / n)
    assert out["last_stage_ms"]["points"] == pytest.approx(step[0])
    assert sum(out["stage_ms"].values()) == pytest.approx(
        out["replay_ms_mean"])
    assert out["replay_ms_median"] == pytest.approx(OFFSETS[-1] * 1e-3)
    assert out["replay_ms"][0] == pytest.approx(OFFSETS[-1] * 1e-3 + 2.0)
    assert summary(names, rows[:0]) == {}


def test_idle_inside_the_replay_span_is_labelled_by_it():
    """A gap of the device inside `stvo.replay`, itself inside
    `stvo.call` and the fleet loop's `vobench.step`, is put on `during
    stvo.replay`, one inside the call but outside the replay on `during
    stvo.call`, when the summary holds the program's spans;
    `trace.summarize` keeps only the drivers' `vobench.*` spans, so the
    result line puts both on `during vobench.step`."""
    from vobench.trace import idle_by_host, summarize

    def span(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        span("vobench.window", 0, 1000), span("vobench.step", 100, 400),
        span("stvo.call", 110, 380), span("stvo.copy_in", 120, 20),
        span("stvo.replay", 200, 100), span("stvo.clone_out", 420, 60),
        span("k", 0, 150, "kernel"), span("k", 320, 30, "kernel"),
        span("k", 450, 550, "kernel")]}
    s = summarize(trace)
    assert idle_by_host(s) == [["during vobench.step",
                                pytest.approx(270e-6)]]
    program = [Event(e["name"], e["ts"], e["dur"])
               for e in trace["traceEvents"]
               if e["name"].startswith("stvo.")]
    gaps = dict(idle_by_host(s._replace(spans=s.spans + program)))
    assert gaps == {"during stvo.replay": pytest.approx(170e-6),
                    "during stvo.call": pytest.approx(100e-6)}

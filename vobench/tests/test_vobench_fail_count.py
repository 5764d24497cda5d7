"""`attempted` and `failed` of the fleet cells count the lane-frames of the
window's first 2 x `seq_frames` steps, so that they do not depend on how
many steps the program fits into the window; `correct` still judges all
of them.  Driven on the CPU as in test_vobench_faults.py, with the timed
path replaced by the oracle, here with its `good` flag false at a fixed
set of (lane, frame) cells, on sequences of 10 frames so that the counted
steps are few."""

import time

import torch

from vobench import registry, run
from vobench.reference import render
from vobench.tests.test_vobench_faults import Oracle, small  # noqa: F401

CELL = "kitti_pl.fleet"
MIX = registry.traffic("fleet")
SEQ = 10
COUNT = 2 * SEQ                                 # the counted steps
COUNTED = MIX["warmup_steps"] + COUNT           # first step not counted
# (lane, frame), each met twice in the counted steps and tracked there,
# its third meeting (pass 2) inside them too
CELLS = [(0, 1), (13, 3), (40, 7), (63, 8)]


class Failing(Oracle):
    """The oracle, with `good` false wherever a lane is at one of `cells`'
    frames (in every pass, or in the `passes` given, numbered as the
    schedule numbers them), a `delay` in seconds on every step, and from
    step `late_from` on the state unchanged: every pose the pass's first,
    and no keyframe."""

    def __init__(self, cells, passes=None, delay=0.0, late_from=None):
        truth = render.smooth_trajectory(SEQ, MIX["speed_m_per_frame"])
        super().__init__(truth, MIX["lanes"])
        self.cells, self.passes = cells, passes
        self.delay, self.late_from = delay, late_from

    def step(self, state, imgs_l, imgs_r):
        s = self.calls
        if self.late_from is not None and s >= self.late_from:
            self.fault = "unchanged"
        state, telem = super().step(state, imgs_l, imgs_r)
        frame = imgs_l[:, 0, 0].round().long()
        lanes = torch.arange(self.lanes)
        pass_no = (SEQ * lanes // self.lanes + s) // SEQ
        bad = torch.zeros(self.lanes, dtype=torch.bool)
        for lane, f in self.cells:
            hit = (lanes == lane) & (frame == f)
            if self.passes is not None:
                hit &= torch.isin(pass_no, torch.tensor(self.passes))
            bad |= hit
        if self.delay:
            time.sleep(self.delay)
        return state, telem._replace(good=(~bad).float())


def _run(system, seconds):
    logs: list = []
    out = run.execute(CELL, 2 ** 31 + 4321, seconds, False, "cpu",
                      system=system, log=logs.append,
                      mix_changes=dict(seq_frames=SEQ))
    return out, logs


def test_two_window_lengths_count_the_same(small):
    counts = []
    # a window that holds at most 5 of the counted steps, and one of 1 s
    for system, seconds in ((Failing(CELLS, delay=0.02), 0.1),
                            (Failing(CELLS), 1.0)):
        out, _ = _run(system, seconds)
        assert out["correct"], out["checks"]
        counts.append((out["attempted"], out["failed"], system.calls))
    (a0, f0, n0), (a1, f1, n1) = counts
    assert n0 == COUNTED < n1   # the windows held different numbers of steps
    assert (a0, f0) == (a1, f1) == (MIX["lanes"] * COUNT, 2 * len(CELLS))


def test_one_more_failing_cell_counts_twice(small):
    base, _ = _run(Failing(CELLS), 0.2)
    more, _ = _run(Failing(CELLS + [(20, 4)]), 0.5)
    assert more["attempted"] == base["attempted"]
    assert more["failed"] == base["failed"] + 2


def test_a_short_window_is_followed_by_the_counted_steps(small):
    system = Failing(CELLS, delay=0.02)
    out, logs = _run(system, 0.1)
    assert system.calls == COUNTED          # the window held at most 5
    assert out["attempted"] == MIX["lanes"] * COUNT
    assert out["failed"] == 2 * len(CELLS)
    assert out["correct"], out["checks"]
    assert any(f"every lane-frame of the run: {MIX['lanes'] * COUNT} "
               f"failed {2 * len(CELLS)} (not compared)" in m
               for m in logs), logs


def test_a_fault_after_the_counted_steps_is_not_correct(small):
    system = Failing([], late_from=COUNTED)
    out, _ = _run(system, 1.0)
    assert system.calls > COUNTED + 2 * SEQ
    assert out["attempted"] == MIX["lanes"] * COUNT
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_the_readout_of_passes_that_disagree(small):
    _, logs = _run(Failing(CELLS), 0.2)
    line = [m for m in logs if "good differs between passes" in m]
    assert len(line) == 1 and " at 0 of " in line[0], logs
    _, logs = _run(Failing(CELLS, passes=[2]), 0.2)
    line = [m for m in logs if "good differs between passes" in m]
    assert f" at {len(CELLS)} of " in line[0], line

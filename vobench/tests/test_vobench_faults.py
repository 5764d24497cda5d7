"""A whole run without the card: the harness's look for a chip skipped,
the rest driven on the CPU (render, traffic driver, comparison, result),
with the timed path replaced by an oracle that answers with the truth, and
then broken underneath.  The oracle comes out correct, and each fault the
cells can have comes out not correct: a step that returns its state
unchanged; half of the batch left out (those lanes' poses never advance),
at the cell's own 64 lanes, and an eighth of it; the pose answer altered
where the step produces it (its translation 10% long, as a wrong baseline
or disparity would make it); in the online cell a back end that returns
its windows' input poses, and one that skips every window.  The oracle's
back end "refines" each window by a fixed shift, and the reference that
judges it (`window_ba.replay`) is replaced by one that expects that
shift: the reference itself is held to the program's back end in
test_vobench_window_ba.py.
The cells run on one card, so there is no exchange between cards to leave
out.  A single answer altered by less than the program's own worst frames
(missed motions of 0.8 m and more in sound runs) is not told apart from
them by any number.  Also: a run on a machine without a card prints no
result and fails."""

import json
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from vobench import registry, run
from vobench.reference import render, window_ba
from vobench.system import WIDTH, pack

TINY = render.Camera(fx=20.0, fy=20.0, cx=8.0, cy=4.0, b=0.5, width=16,
                     height=8)


class State(NamedTuple):
    start: torch.Tensor      # [B] frame the lane's pass started at
    fresh: torch.Tensor      # [B] bool: no frame seen since a reset


class Telem(NamedTuple):
    Tfw: torch.Tensor
    good: torch.Tensor
    is_kf: torch.Tensor
    n_points: torch.Tensor
    n_inliers_pt: torch.Tensor
    n_lines: torch.Tensor
    n_inliers_ls: torch.Tensor
    err_norm: torch.Tensor


class Oracle:
    """Answers each frame with its true pose relative to the pass's first
    frame.  Each image carries its frame index in pixel (0, 0)."""

    pack_width = WIDTH

    def __init__(self, truth, lanes, fault=None):
        self.truth = torch.tensor(truth)
        self.lanes, self.fault, self.calls = lanes, fault, 0

    def fresh(self):
        return State(torch.zeros(self.lanes, dtype=torch.long),
                     torch.ones(self.lanes, dtype=torch.bool))

    def reset(self, state, idx):
        state.fresh[idx] = True

    def pack(self, telem):
        return pack(telem, self.lanes)

    def step(self, state, imgs_l, imgs_r):
        self.calls += 1
        f = imgs_l[:, 0, 0].round().long()
        start = torch.where(state.fresh, f, state.start)
        T = torch.linalg.inv(self.truth[start]) @ self.truth[f]
        kf = ((f - start) % 5 == 0) & (f != start)
        if self.fault == "unchanged":           # the state never moves on
            T = torch.eye(4, dtype=T.dtype).expand_as(T)
            start, kf = state.start, torch.zeros_like(kf)
        elif self.fault == "half_batch":
            T = T.clone()
            T[self.lanes // 2:] = torch.eye(4, dtype=T.dtype)
        elif self.fault == "eighth":
            T = T.clone()
            T[self.lanes - self.lanes // 8:] = torch.eye(4, dtype=T.dtype)
        elif self.fault == "altered":
            T = T.clone()
            T[:, :3, 3] *= 1.1
        n = torch.full((self.lanes,), 40.0)
        telem = Telem(Tfw=T.float(), good=torch.ones(self.lanes), is_kf=kf,
                      n_points=n, n_inliers_pt=n, n_lines=n, n_inliers_ls=n,
                      err_norm=torch.zeros(self.lanes))
        return State(start, torch.zeros_like(state.fresh)), telem


SHIFT = np.diag([1.0, 1.0, 1.0, 1.0])
SHIFT[0, 3] = 0.3           # the oracle back end's "refinement"


def _windows(frames):
    """(frame indices, input poses) of each window: a keyframe every 3
    frames, 4 to a window, the last keyframe opening the next."""
    ring = []
    for f, T in frames:
        if f % 3:
            continue
        ring.append((f, np.asarray(T, np.float64)))
        if len(ring) == 4:
            yield [i for i, _ in ring], np.stack([t for _, t in ring])
            ring = ring[-1:]


class OracleBA:
    """Refines every window by SHIFT; `ba_unrefined` returns the input
    poses, `ba_skipped` no window."""

    def __init__(self, fault):
        self.fault, self.ring, self.refine_times = fault, [], []

    def observe(self, frame, Tfw, is_kf, points, lines):
        if frame % 3:
            return None
        self.ring.append((frame, np.asarray(Tfw, np.float64)))
        if len(self.ring) < 4:
            return None
        idx, T = [i for i, _ in self.ring], np.stack([t for _, t in
                                                      self.ring])
        self.ring = self.ring[-1:]
        if self.fault == "ba_skipped":
            return None
        self.refine_times.append(0.001)
        return idx, T if self.fault == "ba_unrefined" else SHIFT @ T


def expected_windows(frames, cam, settings, device, program=None):
    """Stands in for `window_ba.replay`: the oracle back end's windows."""
    out = {}
    for key, f, T, kf, pts, lns in frames:
        out.setdefault(key, []).append((f, T))
    return {k: [window_ba.Window(tuple(i), True, SHIFT @ T)
                for i, T in _windows(v)] for k, v in out.items()}


class OnlineOracle(Oracle):
    def __init__(self, truth, fault=None):
        super().__init__(truth, 1, fault)

    def fresh(self):
        return _map1(super().fresh())

    def step(self, state, img_l, img_r):
        s, t = super().step(_lane(state), img_l[None], img_r[None])
        return _map1(s), type(t)(*[x[0] for x in t])

    def pack(self, telem):
        return pack(type(telem)(*[x[None] for x in telem]), 1)

    def new_ba(self):
        return OracleBA(self.fault)

    @staticmethod
    def keyframe_sets(state):
        return None, None

    @staticmethod
    def observe(ba, frame, Tfw, is_kf, state):
        return ba.observe(frame, Tfw, is_kf, None, None)


def _map1(s):
    return type(s)(*[x[0] for x in s])


def _lane(s):
    return type(s)(*[x[None] for x in s])


@pytest.fixture
def small(monkeypatch):
    """The cells' traffic with frames that name themselves, at a size the
    CPU holds: the fleet at its own lane count, the online cell (pending)
    with its sensor faster."""
    def render_pool(seed, lanes, cam, scene_kw, n_frames, speed, device):
        truth = render.smooth_trajectory(n_frames, speed=speed)
        f = torch.arange(n_frames, dtype=torch.float32).repeat(lanes)
        imgs = f[:, None, None].expand(lanes * n_frames, TINY.height,
                                       TINY.width).contiguous()
        return imgs, imgs.clone(), truth

    monkeypatch.setattr(render, "render_pool", render_pool)
    monkeypatch.setattr(window_ba, "replay", expected_windows)
    man = registry.with_pending(registry.manifest(), "kitti_pl.online_ba")
    monkeypatch.setattr(registry, "manifest", lambda: man)
    return lambda: render.smooth_trajectory(60, speed=0.8)


FAULTS = {"kitti_pl.fleet": ["unchanged", "half_batch", "eighth", "altered"],
          "kitti_points.fleet": ["unchanged", "half_batch", "eighth",
                                 "altered"],
          "kitti_pl.online_ba": ["unchanged", "altered", "ba_unrefined",
                                 "ba_skipped"]}


def _run(cell, fault, truth):
    mix = registry.traffic(registry.cell(registry.manifest(), cell)["traffic"])
    if cell.endswith("online_ba"):
        system, changes = OnlineOracle(truth, fault), dict(rate_hz=400.0)
    else:
        system, changes = Oracle(truth, mix["lanes"], fault), None
    return run.execute(cell, 2 ** 31 + 99, 0.4, False, "cpu", system=system,
                       log=lambda m: None, mix_changes=changes)


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_oracle_is_correct(small, cell):
    out = _run(cell, None, small())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out, allow_nan=False)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_a_fault_is_not_correct(small, cell, fault):
    out = _run(cell, fault, small())
    assert not out["correct"], (fault, out["checks"])


def test_no_card_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "vobench.run", "--workload", "kitti_pl.fleet",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout

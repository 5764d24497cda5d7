"""The cell `euroc_pl.online` without the card.

- Their readers on hand-made traced slices: the rectified step's seven
  stamps bound `rectify_device_ms.online` and `vo_device_ms.online`, and a
  trace with six stamps a step (a step without the rectification), none,
  or no trace gives nothing.
- Whole runs of the cell on the CPU with the oracle of
  test_vobench_faults.py in the program's place: correct, and each fault
  not correct under the cell's limits.
- The online cell with the program itself, on the CPU, at a size the CPU
  holds (the EuRoC rig scaled to 240 x 180, the small VO settings): the
  raw frames of the plain reference (vobench/reference/rectify.py) through
  the step that rectifies them come out correct, and through a step built
  without the rectification not correct.
"""

import numpy as np
import pytest
import torch

from vobench import registry, run
from vobench.reference import rectify as ref
from vobench.reference import render
from vobench.run import Readings
from vobench.stamps import RECTIFIED, log_stages
from vobench.stages import STAMP
from vobench.tests.test_vobench_faults import TINY, OnlineOracle
from vobench.trace import Event, TraceSummary

# per replay: the seven stamps' offsets from its start, us
OFFSETS = (0.0, 45.0, 3_500.0, 11_200.0, 11_450.0, 11_850.0, 12_650.0)
STARTS = (1_000.0, 51_000.0, 101_000.0)


def _trace(offsets=OFFSETS, starts=STARTS):
    kernels = [Event(STAMP + "(long long*, long long*, int, int, int, int)",
                     t0 + off, 1.0) for t0 in starts for off in offsets]
    kernels += [Event("work_kernel", t0 + 10.0, 100.0)
                for t0 in starts]
    kernels.sort(key=lambda e: e.ts)
    return TraceSummary(device=kernels, kernels=kernels, spans=[],
                        window=(0.0, 150_000.0))


def _readings(trace, steps=len(STARTS)):
    return Readings(vo={}, cam={}, lanes=1, trace=trace, steps_traced=steps,
                    graph_nodes=None, step_host_ms=[], refine_s=[])


def _read(metric, r):
    return registry.reader(metric).read(r)


def test_rectified_step_readers(capsys):
    r = _readings(_trace())
    assert _read("rectify_device_ms.online", r) == pytest.approx(0.045)
    assert _read("vo_device_ms.online", r) == pytest.approx(12.605)
    err = capsys.readouterr().err
    assert "rectify 0.045" in err and "keyframe 0.800" in err
    log_stages(_readings(None), RECTIFIED)      # nothing to print
    assert capsys.readouterr().err == ""
    for r in (_readings(_trace(offsets=OFFSETS[:1] + OFFSETS[2:])),
              _readings(_trace(starts=())), _readings(None),
              _readings(_trace(), steps=0)):
        assert _read("rectify_device_ms.online", r) is None
        assert _read("vo_device_ms.online", r) is None


@pytest.fixture
def tiny(monkeypatch):
    """Frames that name themselves (vobench/tests/test_vobench_faults.py)
    at a size the CPU holds."""
    def render_pool(seed, lanes, cam, scene_kw, n_frames, speed, device):
        truth = render.smooth_trajectory(n_frames, speed=speed)
        f = torch.arange(n_frames, dtype=torch.float32).repeat(lanes)
        imgs = f[:, None, None].expand(lanes * n_frames, TINY.height,
                                       TINY.width).contiguous()
        return imgs, imgs.clone(), truth

    monkeypatch.setattr(render, "render_pool", render_pool)


def _oracle_run(fault):
    mix = registry.traffic("euroc_online")
    truth = render.smooth_trajectory(mix["seq_frames"],
                                     speed=mix["speed_m_per_frame"])
    # frames that name themselves are not made raw
    return run.execute("euroc_pl.online", 2 ** 31 + 77, 0.3, False, "cpu",
                       system=OnlineOracle(truth, fault),
                       log=lambda m: None,
                       mix_changes=dict(rate_hz=2000.0, raw=False))


def test_the_oracle_is_correct(tiny):
    out = _oracle_run(None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_fault_is_not_correct(tiny, fault):
    out = _oracle_run(fault)
    assert not out["correct"], (fault, out["checks"])


@pytest.fixture
def small_rig(monkeypatch):
    """euroc_pl with the rig scaled to 240 x 180 and the small VO
    settings of the port's tests."""
    base = registry.config("euroc_pl")
    raw = dict(base["raw"])
    for k in ("Kl", "Kr"):
        f, g, cx, cy = raw[k]
        raw[k] = [f * 240 / 752, g * 180 / 480, cx * 240 / 752,
                  cy * 180 / 480]
    cam = ref.rectified_camera(ref.Rig.of(dict(
        raw=raw, camera=dict(width=240, height=180))))
    cfg = dict(base, raw=raw, camera=dict(cam, rate_hz=20.0),
               vo=dict(base["vo"], orb_nfeatures=300, orb_nlevels=2,
                       lsd_nfeatures=48, lsd_n_dirs=8))
    config = registry.config
    monkeypatch.setattr(registry, "config", lambda name, base=registry.HERE:
                        cfg if name == "euroc_pl" else config(name, base))
    return cfg


SMALL_MIX = dict(sequences=2, seq_frames=8, warmup_frames=3,
                 rate_hz=400.0,
                 scene=dict(n_points=600, n_lines=32, extent=[8.0, 4.0, 16.0],
                            z_near=1.5))


def test_the_program_on_raw_frames(small_rig):
    """The cell's own system on the CPU: correct on the raw frames it
    rectifies; fed them unrectified, not correct."""
    from vobench.system_online import RawOnline
    torch.set_num_threads(2)
    outs = {}
    for name, system in (("sound", None),
                         ("no_rectify", RawOnline(small_rig, "cpu",
                                                  rectify=False))):
        outs[name] = run.execute("euroc_pl.online", 2 ** 33 + 5, 0.05,
                                 False, "cpu", system=system,
                                 log=lambda m: None, mix_changes=SMALL_MIX)
    assert outs["sound"]["correct"], outs["sound"]["checks"]
    assert outs["sound"]["attempted"] == 20
    assert not outs["no_rectify"]["correct"], outs["no_rectify"]["checks"]
    assert np.isfinite(outs["sound"]["metrics"]["frame_ms_p95"]["value"])

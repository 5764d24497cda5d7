"""The controls on the card, at a size a test run holds: the fleet cell of
the point-and-line configuration with 8 lanes, and the online cell (kept
out of BENCHMARK.json for now, vobench/pending/), each with a 10 s
window.  The program as configured comes out correct; its
carried state in bfloat16, the step with its line half dropped, and a back
end that returns its windows' input poses come out not correct.  Run on a
machine with a card:

    python -m pytest vobench/tests/test_vobench_gpu.py -m gpu
"""

import pytest

from vobench import controls, registry, run

CASES = [("kitti_pl.fleet", "sound", True), ("kitti_pl.fleet", "bf16_state",
                                             False),
         ("kitti_pl.fleet", "no_lines", False),
         ("kitti_pl.online_ba", "sound", True),
         ("kitti_pl.online_ba", "ba_unrefined", False)]


@pytest.fixture
def card(monkeypatch):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run.cache_env()
    man = registry.with_pending(registry.manifest(), "kitti_pl.online_ba")
    monkeypatch.setattr(registry, "manifest", lambda: man)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,variant,correct", CASES)
def test_control_on_the_card(card, cell, variant, correct):
    changes = dict(lanes=8) if cell.endswith("fleet") else None
    system = controls.build(cell, variant, changes)
    out = run.execute(cell, 2 ** 31 + 2024, 10.0, False, "cuda",
                      system=system, log=lambda m: None, mix_changes=changes)
    assert out["correct"] is correct, out["checks"]

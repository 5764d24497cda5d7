"""Stage stamps of the captured programs (stvo_pl_tpu_torch/utils/
profiling.py `stamp`, `stamping`, `StageRing`; parallel/compiled.py) and
the host spans of a call.

On the CPU a program runs its body eagerly inside a `stamping` block, so
its ring takes the host's clock: one row per call, the six names of the
VO step in order, times that never decrease.  The ring keeps its last
`rows` rows once it wraps; a run that stamps other names than the first
raises; a bare step, outside any block, stamps nothing and equals the
stamped program bit for bit; a `compile_fn` program has no stamps.  A
call is the span `stvo.call` with `stvo.copy_in`, `stvo.replay` and
`stvo.clone_out` inside it.

The `gpu` cases hold the captured batched step's graph to exactly six
`stage_stamp_kernel` nodes, the ring's device counter to `replays`, and
the device clock's rows to increase within and across replays; they skip
without a CUDA device and import no JAX, so on a machine with a card they
run as `python -m pytest --noconftest -m gpu tests/test_torch_stages.py`.
"""

import json

import pytest
import torch

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.parallel import batched, compiled
from stvo_pl_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the smallest configuration of tests/test_torch_compiled.py
CAM = tcam.StereoCamera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3,
                        width=240, height=180)
CFG = VOConfig(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
               lsd_n_dirs=8, min_features=8, fast_feat_th=20)
NAMES = ["begin", "points", "lines", "f2f", "optimizer", "keyframe"]


def _lanes(device, n: int):
    """Two lanes of the port's renderer (scenes of seeds 0 and 7) at
    240x180, n frames: left and right [2, n, H, W] on `device`."""
    from stvo_pl_tpu_torch.utils import synthetic
    poses = synthetic.smooth_trajectory(n, speed=0.25, device=device)
    L, R = [], []
    for seed in (0, 7):
        gen = torch.Generator(device=device).manual_seed(seed)
        scene = synthetic.make_scene(gen, n_points=260, n_lines=24,
                                     extent=(14.0, 8.0, 40.0), z_near=3.0)
        left, right = synthetic.render_sequence(scene, poses, CAM)
        L.append(left)
        R.append(right)
    return torch.stack(L), torch.stack(R)


def _counter(ring) -> int:
    """The runs a ring has written: its counter, the buffer's last entry
    (on CUDA the device counter)."""
    return int(ring.buf[-1]) if ring.buf is not None else 0


def _leaves(tree) -> list:
    out = []
    compiled._flatten(tree, out)
    return out


@pytest.fixture(scope="module")
def stamped_run():
    """Three frames of two lanes through the CPU route of the compiled
    batched step and through the bare `vo_step_batched`: the program and
    the (state, telemetry) of each call on either side."""
    L, R = _lanes("cpu", 3)
    step = batched.compile_vo_step(CAM, CFG, 2, device="cpu")
    s_c = batched.init_batched_state(CFG, 2, device="cpu")
    s_e = batched.init_batched_state(CFG, 2, device="cpu")
    runs_c, runs_e = [], []
    for i in range(3):
        s_c, t_c = step(s_c, L[:, i], R[:, i])
        assert not profiling._rings       # no block is left open
        s_e, t_e = batched.vo_step_batched(s_e, L[:, i], R[:, i], CAM, CFG)
        runs_c.append((s_c, t_c))
        runs_e.append((s_e, t_e))
    return step, runs_c, runs_e


def test_compiled_step_writes_one_row_per_call(stamped_run):
    step, runs_c, _ = stamped_run
    names, ns = step.stages()
    assert names == NAMES
    assert ns.dtype == torch.int64 and ns.shape == (3, len(NAMES))
    assert bool((ns[:, 1:] >= ns[:, :-1]).all())
    assert bool((ns[1:, 0] >= ns[:-1, -1]).all())
    prog, = step.programs.values()
    assert _counter(prog.ring) == 3 and prog.replays == 0


def test_bare_step_equals_the_stamped_program(stamped_run):
    """Outside a `stamping` block a stamp does nothing: the bare step and
    the stamped program agree bit for bit on every call."""
    _, runs_c, runs_e = stamped_run
    for i, (c, e) in enumerate(zip(runs_c, runs_e)):
        lc, le = _leaves(c), _leaves(e)
        assert len(lc) == len(le)
        assert all(torch.equal(x, y) for x, y in zip(lc, le)), i
    profiling.stamp("begin")                 # no block open: nothing


def test_ring_keeps_the_last_rows_after_it_wraps(monkeypatch):
    clock = iter(range(1000, 100000, 10))
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(clock))
    ring = profiling.StageRing("cpu", rows=3)
    assert ring.stages()[0] == [] and _counter(ring) == 0
    written = []
    for _ in range(7):
        with profiling.stamping(ring):
            for name in ("begin", "a", "b"):
                profiling.stamp(name)
        written.append(ring.stages()[1][-1].tolist())
    names, ns = ring.stages()
    assert names == ["begin", "a", "b"] and _counter(ring) == 7
    assert ns.tolist() == written[-3:]
    assert written[0] == [1000, 1010, 1020] and written[-1][0] == 1180


def test_a_run_must_stamp_the_first_runs_names():
    ring = profiling.StageRing("cpu", rows=4)
    with profiling.stamping(ring):
        profiling.stamp("begin")
        profiling.stamp("a")
    for other in (("begin",), ("begin", "b"), ("begin", "a", "c")):
        with pytest.raises(RuntimeError, match="first run"):
            with profiling.stamping(ring):
                for name in other:
                    profiling.stamp(name)
    assert _counter(ring) == 1 and not profiling._rings


def test_nested_blocks_stamp_the_innermost_ring():
    outer = profiling.StageRing("cpu", rows=2)
    inner = profiling.StageRing("cpu", rows=2)
    with profiling.stamping(outer):
        profiling.stamp("begin")
        with profiling.stamping(inner):
            profiling.stamp("inner")
        profiling.stamp("end")
    assert outer.stages()[0] == ["begin", "end"]
    assert inner.stages()[0] == ["inner"]


def test_compile_fn_programs_report_no_stages():
    def add(a, b):
        return a + b

    prog = compiled.compile_fn(add, ("a", "b"), device="cpu")
    x = torch.arange(4.0)
    for _ in range(2):
        assert torch.equal(prog(x, x), 2 * x)
    names, ns = prog.stages()
    assert names == [] and ns.numel() == 0
    (p,) = prog.programs.values()
    assert p.ring.buf is None and _counter(p.ring) == 0
    prog(torch.zeros(3), torch.zeros(3))        # a second program
    with pytest.raises(ValueError, match="one program"):
        prog.stages()


def test_a_call_is_a_host_span_with_its_parts(tmp_path):
    """Under torch.profiler a call is `stvo.call`, and `stvo.copy_in`,
    `stvo.replay` and `stvo.clone_out` lie inside it, in that order."""
    from torch.profiler import ProfilerActivity, profile

    def body(x):
        profiling.stamp("begin")
        return x * 2

    prog = compiled.Compiled(body, "cpu")
    x = torch.ones(8)
    prog(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog(x)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("stvo.")}
    assert set(spans) == {"stvo.call", "stvo.copy_in", "stvo.replay",
                          "stvo.clone_out"}
    lo, hi = spans["stvo.call"]
    parts = [spans[k] for k in ("stvo.copy_in", "stvo.replay",
                                "stvo.clone_out")]
    assert all(lo <= a <= b <= hi for a, b in parts)
    assert parts[0][1] <= parts[1][0] and parts[1][1] <= parts[2][0]
    assert prog.stages()[1].shape == (2, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a graph is captured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_captured_step_stamps_every_replay(cuda):
    """The captured batched step's graph holds exactly six stamp kernel
    nodes; after 10 calls the ring's device counter equals `replays`, and
    the device clock increases within every row and from each row to the
    next; a capture's warm-up writes no row."""
    from chip_smoke import graph_nodes, kept_graphs
    L, R = _lanes(cuda, 4)
    step = batched.compile_vo_step(CAM, CFG, 2, device=cuda)
    s = batched.init_batched_state(CFG, 2, device=cuda)
    launches = profiling.stage_stamp.launches
    with kept_graphs():
        for i in range(10):
            s, _ = step(s, L[:, i % 4].contiguous(), R[:, i % 4].contiguous())
    prog, = step.programs.values()
    # the warm-up's six and the capture's six; replays launch no Python
    assert profiling.stage_stamp.launches - launches == 12
    nodes = graph_nodes(prog.graph)[0]
    assert sum(n for name, n in nodes.items()
               if "stage_stamp_kernel" in name) == 6
    assert prog.replays == 10 and _counter(prog.ring) == 10
    names, ns = step.stages()
    assert names == NAMES and ns.shape == (10, len(NAMES))
    assert bool((ns[:, 1:] > ns[:, :-1]).all()), ns
    assert bool((ns[1:, 0] > ns[:-1, -1]).all()), ns
    torch.cuda.synchronize()

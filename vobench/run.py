"""The benchmark of `stvo_pl_tpu_torch` on NVIDIA H100s: one run of one cell.

    python -m vobench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`.  One run is one
process: it renders its inputs from the seed on the card, builds the
cell's system (vobench/system.py) and warms it up (set-up), drives the
window for `--seconds` with the cell's traffic driver, then judges every
answer of the window against the renderer's ground truth
(vobench/reference/compare.py), in the online cell every BA window against
the plain reference's (vobench/reference/window_ba.py), and prints one
JSON line as the last line of its standard output.  With `--trace 0` the
line carries the cell's end-to-end metrics; with `--trace 1` a traced
slice follows the window, and the line carries the per-layer metrics that
their readers (vobench/metrics/) take from it, with the device's busy
time and a breakdown.  `attempted` and `failed` count the lane-frames that
the traffic driver counts (the fleet's: those of the window's first
2 x `seq_frames` steps, the same at any speed).  The numbers compared, each
with its limit (vobench/limits/<cell>.json), are the last lines of
standard error and the last key of the JSON line.

A run exits with a code other than 0, and prints no result, when it finds
no CUDA device or fewer than the cell asks for, and when a module of JAX or
of the JAX package (`stvo_pl_tpu`, compared as a whole top-level name) is
loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()      # set-up is timed from the process' start

import argparse                # noqa: E402
import json                    # noqa: E402
import os                      # noqa: E402
import subprocess              # noqa: E402
import sys                     # noqa: E402
from typing import NamedTuple  # noqa: E402

from vobench import registry   # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "stvo_pl_tpu")
CACHE = registry.ROOT / "build" / "vobench-cache"


def cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the program's kernels build into `build/kernels-<hash>/` by
    themselves)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose whole top-level name is JAX's or the JAX
    package's (`stvo_pl_tpu_torch` is neither)."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return out.replace("\n", "; ")


class Readings(NamedTuple):
    """What the per-layer readers read (vobench/metrics/)."""
    vo: dict
    cam: dict
    lanes: int
    trace: object           # vobench.trace.TraceSummary or None
    steps_traced: int
    graph_nodes: int | None
    step_host_ms: list
    refine_s: list


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device, t0: float = _T0, system=None, log=None,
            sink: dict | None = None,
            mix_changes: dict | None = None) -> dict:
    """One run of a cell on `device`; returns the result line's object
    (`checks` last).  A `system` passed in (a control's, reused over many
    seeds, or a test's stand-in) takes the place of the one the cell's
    driver builds, and is kept; the judgement always holds the cell's own
    configuration.  `sink` receives every number the comparison computed
    and their distributions.  `mix_changes` replaces entries of the cell's
    traffic mix (the lane sweep's lane count, a test's smaller size)."""
    import torch

    from vobench.reference import compare, render
    from vobench.trace import (Tracer, busy_seconds, idle_by_host,
                               top_device_ops, window_seconds)

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    man = registry.manifest()
    w = registry.cell(man, cell_name)
    cfg = registry.config(w["config"])
    mix = dict(registry.traffic(w["traffic"]), **(mix_changes or {}))
    e2e_m, layer_m = registry.metrics_of(man, cell_name)
    limits = registry.limits(cell_name)
    drv = registry.driver(mix["kind"])

    cam = render.Camera(*(cfg["camera"][k] for k in render.Camera._fields))
    left, right, truth = render.render_pool(
        seed, mix.get("sequences", mix["lanes"]), cam, mix["scene"],
        mix["seq_frames"], mix["speed_m_per_frame"], device)
    keep = system is not None
    if not keep:
        system = drv.build(cfg, mix, device)
    tracer = Tracer(trace and cuda)
    setup = {}

    def segments():
        """The caching allocator's device allocations so far."""
        return (torch.cuda.memory_stats(device).get("segment.all.allocated",
                                                   0) if cuda else 0)

    def on_warm():
        if cuda:
            torch.cuda.synchronize()
        setup["s"] = time.perf_counter() - t0
        setup["segments"] = segments()

    if tracer.enabled:
        from vobench.reference.graph_nodes import graph_nodes, kept_graphs
        with kept_graphs():
            res = drv.run(system, (left, right), mix, seconds, tracer,
                          on_warm)
        nodes = sum(graph_nodes(system.graph())[0].values())
    else:
        res = drv.run(system, (left, right), mix, seconds, tracer, on_warm)
        nodes = None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"[vobench] device segments allocated after set-up: "
        f"{segments() - setup['segments']}")
    del left, right
    if not keep:
        del system
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    numbers = compare.judge(res.frames, truth, cfg["vo"]["has_lines"],
                            cfg["vo"]["max_kf_t_dist"])
    if res.ba is not None:
        from vobench.reference import window_ba
        t_ref = time.perf_counter()
        windows = window_ba.replay(res.ba[1], cam, window_ba.Settings.of(
            cfg["vo"], mix["ba"]), device, program=res.ba[0])
        numbers.update(compare.judge_ba(res.ba[0], windows))
        log(f"[vobench] the reference refined {numbers['ba_windows_ref']} "
            f"BA windows in {time.perf_counter() - t_ref:.1f} s")
    correct, checks = compare.verdict(numbers, limits)
    if sink is not None:
        sink.update(numbers, detail=compare.detail(res.frames, truth))
    attempted = len(res.counted)
    failed = compare.failed_frames(res.counted)
    for k, v in sorted(numbers.items()):
        if k not in checks:
            log(f"[vobench] {k} {v!r} (not compared)")
    for k, v in sorted(res.e2e.items()):
        log(f"[vobench] {k} {v!r}")
    if res.counted is not res.frames:
        log(f"[vobench] every lane-frame of the run: {len(res.frames)} "
            f"failed {compare.failed_frames(res.frames)} (not compared)")
        rep = compare.pass_disagreement(res.frames)
        log(f"[vobench] good differs between passes from the same start "
            f"at {rep['cells_differ']} of {rep['cells_seen']} (lane, frame) "
            f"cells met twice or more; largest pose gap between them "
            f"{rep['pose_gap_m']!r} m (not compared)")
    log(f"[vobench] setup_s {setup['s']!r}  lane-frames {attempted}  "
        f"failed {failed}  peak {peak}")

    out = dict(correct=bool(correct and attempted > 0),
               attempted=attempted, failed=int(failed))
    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(device) if cuda
                    else "cpu", count=int(w["chips"]),
                    memory_peak_bytes=int(peak))
    metrics = {}
    if not trace:
        have = dict(res.e2e, setup_s=setup["s"])
        for m in e2e_m:
            if m["name"] not in have:
                raise RuntimeError(f"the {mix['kind']} driver gives no "
                                   f"{m['name']}")
            metrics[m["name"]] = dict(value=have[m["name"]], unit=m["unit"])
    else:
        readings = Readings(vo=cfg["vo"], cam=cfg["camera"],
                            lanes=mix["lanes"], trace=res.trace,
                            steps_traced=res.steps_traced,
                            graph_nodes=nodes, step_host_ms=res.step_host_ms,
                            refine_s=res.refine_s)
        for m in layer_m:
            v = registry.reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        if res.trace is not None:
            dev_info.update(busy_s=busy_seconds(res.trace),
                            window_s=window_seconds(res.trace))
            out["breakdown"] = dict(device_ops=top_device_ops(res.trace),
                                    idle_gaps=idle_by_host(res.trace))
    out.update(metrics=metrics, device=dev_info)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env()
    import torch
    chips = registry.cell(registry.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[vobench] {args.workload} needs {chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}: no run",
              file=sys.stderr)
        return 3
    print(f"[vobench] card {card_line()}; cell {args.workload} seed "
          f"{args.seed} seconds {args.seconds} trace {args.trace}",
          file=sys.stderr, flush=True)
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda")
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"[vobench] JAX or the JAX package is loaded: {bad}: no "
              f"result", file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        print(f"[vobench] check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

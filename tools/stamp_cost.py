"""What the stage stamps cost a replay of the captured batched step, and
what the program's host spans read.

The step of a fleet cell's configuration and lane count is captured twice
on the card: with its stage stamps (as every program is) and without
them.  Both then replay the same second frame of their lanes in turns
(plain, stamped, stamped, plain, ...), each turn `--replays` calls timed
with CUDA events.  Then `--replays` calls of the stamped program run
under torch.profiler (host activity only), which reads each `stvo.*`
span of `Compiled.__call__` (`stvo.call`, `stvo.copy_in`, `stvo.replay`,
`stvo.clone_out`).  One JSON line gives each program's ms per call by
turn, their medians, the stamped graph's extra share and each span's
mean host ms per call.

The plain capture is made with `parallel/compiled.stamping` replaced by
a block that does nothing, for that one capture: a one-off of this tool,
so that the program keeps a single path.  Its six stamps then do nothing.

    python3 tools/stamp_cost.py [--cell kitti_pl.fleet] [--replays 20] \\
        [--rounds 3] [--seed 1]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from stvo_pl_tpu_torch.parallel import compiled  # noqa: E402
from vobench import registry, run  # noqa: E402
from vobench.reference import render  # noqa: E402
from vobench.system import Fleet  # noqa: E402


def timed(step, state, imgs_l, imgs_r, n: int) -> float:
    """ms per call over n calls of the step on the same arguments."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step(state, imgs_l, imgs_r)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_spans(step, state, imgs_l, imgs_r, n: int) -> dict:
    """Mean host ms per call of each `stvo.*` span over n calls of the
    step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            step(state, imgs_l, imgs_r)
        torch.cuda.synchronize()
    return {e.key: e.cpu_time_total * 1e-3 / n for e in prof.key_averages()
            if e.key.startswith("stvo.")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stamp_cost")
    ap.add_argument("--cell", default="kitti_pl.fleet")
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    run.cache_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = registry.cell(registry.manifest(), args.cell)
    cfg, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    B = mix["lanes"]
    cam = render.Camera(*(cfg["camera"][k] for k in render.Camera._fields))
    left, right, _ = render.render_pool(args.seed, B, cam, mix["scene"], 2,
                                        mix["speed_m_per_frame"], "cuda")
    frame = [(left[f::2].contiguous(), right[f::2].contiguous())
             for f in (0, 1)]
    systems = {}
    for kind in ("plain", "stamped"):
        sys_ = Fleet(cfg, B, "cuda")
        real = compiled.stamping
        if kind == "plain":
            compiled.stamping = lambda ring: contextlib.nullcontext()
        try:
            state, _ = sys_.step(sys_.fresh(), *frame[0])   # the capture
        finally:
            compiled.stamping = real
        systems[kind] = (sys_, state)
    for kind, (sys_, _) in systems.items():
        n = len(sys_.step.stages()[0])
        if n != (0 if kind == "plain" else 6):
            raise RuntimeError(f"the {kind} program has {n} stamps")
    ms = {k: [] for k in systems}
    order = ("plain", "stamped", "stamped", "plain")
    for _ in range(args.rounds):
        for kind in order:
            sys_, state = systems[kind]
            ms[kind].append(timed(sys_.step, state, *frame[1],
                                  args.replays))
    med = {k: statistics.median(v) for k, v in ms.items()}
    sys_, state = systems["stamped"]
    spans = host_spans(sys_.step, state, *frame[1], args.replays)
    print(json.dumps(dict(
        cell=args.cell, lanes=B, card=run.card_line(),
        replays_per_turn=args.replays, ms_per_call=ms, median_ms=med,
        stamped_extra_pct=100.0 * (med["stamped"] / med["plain"] - 1.0),
        host_ms_per_call=spans)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The captured step's stage rows over a whole run, read from the
program's ring (`Compiled.stages()` of stvo_pl_tpu_torch), beside the
traced slice that the per-layer readers take.

    python -m vobench.stage_window --workload kitti_pl.fleet --seed <n> \\
        [--seconds 30]

One run of a cell as `python -m vobench.run --trace 1` makes it
(`run.execute`, with the system kept), then one JSON line: the
end-to-end numbers the run logged, `correct`, its per-layer metrics, and
from the ring, for the window's replays (the warm-up and the traced
slice left out, so the profiler is off) and for the traced slice's: each
stage's mean device ms over all of them, over the first `EDGE` and over
the last `EDGE`, and the replays' median, 95th percentile, mean and each
one's ms in order.  A process that starts slow (PERF.md §6) shows it as
the first stage means above the last.  It runs on a card; no cell runs
it.  A program without stamps has no rows: the line then holds none.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from vobench import registry, run

EDGE = 16       # replays at either end of the window with means of their own


def summary(names: list, ns: np.ndarray) -> dict:
    """Per-stage mean device ms and the replays' ms of the rows `ns`
    [n, len(names)] (nanoseconds)."""
    if not len(ns):
        return {}
    stage = np.diff(ns, axis=1) * 1e-6
    replay = stage.sum(axis=1)

    def means(rows):
        return {n: float(v) for n, v in zip(names[1:], rows.mean(axis=0))}

    return dict(rows=len(ns), stage_ms=means(stage),
                first_stage_ms=means(stage[:EDGE]),
                last_stage_ms=means(stage[-EDGE:]),
                replay_ms_median=float(np.median(replay)),
                replay_ms_p95=float(np.percentile(replay, 95)),
                replay_ms_mean=float(replay.mean()),
                replay_ms=[round(float(v), 2) for v in replay])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.stage_window",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    run.cache_env()
    man = registry.manifest()
    w = registry.cell(man, args.workload)
    mix = registry.traffic(w["traffic"])
    e2e_names = {m["name"] for m in registry.metrics_of(man, w["name"])[0]}
    logged: dict = {}

    def log(msg: str):
        print(msg, file=sys.stderr, flush=True)
        parts = msg.split()
        if len(parts) == 3 and parts[1] in e2e_names:
            logged[parts[1]] = float(parts[2])

    system = registry.driver(mix["kind"]).build(
        registry.config(w["config"]), mix, "cuda")
    out = run.execute(args.workload, args.seed, args.seconds, True, "cuda",
                      system=system, log=log)
    names, ns = system.step.stages()
    ns = ns.numpy()
    (prog,) = system.step.programs.values()
    if names and prog.replays != len(ns):
        raise RuntimeError(f"{prog.replays} replays, {len(ns)} rows: the "
                           f"ring wrapped")
    warm, traced = mix["warmup_steps"], mix["traced_steps"]
    line = dict(workload=args.workload, seed=args.seed,
                card=run.card_line(), correct=out["correct"], **logged,
                metrics={k: v["value"] for k, v in out["metrics"].items()},
                stages=names,
                window=summary(names, ns[warm:len(ns) - traced]),
                traced=summary(names, ns[len(ns) - traced:]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The one sweep that fixed the fleet cells' lane count B: the fleet cell
at each B for a short window, each run in a process of its own, and a
markdown table of frames per second by B.  B is the smallest lane count
whose median rate is within 5% of the best.  It runs on a card; no cell
runs it.

    python -m vobench.sweep_lanes [--cell kitti_pl.fleet] \\
        [--lanes 8 16 32 64] [--seconds 10] [--rounds 2] \\
        [--out build/lane_sweep.md]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from vobench import run

WITHIN = 0.05


def one(cell: str, lanes: int, seconds: float, seed: int) -> dict:
    """One run of the cell with its traffic's lane count set to `lanes`."""
    out = run.execute(cell, seed, seconds, False, "cuda",
                      mix_changes=dict(lanes=lanes))
    return dict(lanes=lanes, seed=seed, correct=out["correct"],
                **{k: v["value"] for k, v in out["metrics"].items()},
                memory_peak_bytes=out["device"]["memory_peak_bytes"])


def table(rows: list, lanes: list, card: str) -> tuple[str, int]:
    med = {b: statistics.median(r["frames_per_s"] for r in rows
                                if r["lanes"] == b) for b in lanes}
    best = max(med.values())
    choice = min(b for b in lanes if med[b] >= (1 - WITHIN) * best)
    lines = [f"Lane sweep ({card}): frames_per_s per run, its median, "
             f"frame_ms_p95 and setup_s per run, peak memory.", "",
             "| B | frames_per_s | median | frame_ms_p95 | setup_s | "
             "peak GB | correct |", "|---|---|---|---|---|---|---|"]
    for b in lanes:
        rs = [r for r in rows if r["lanes"] == b]
        lines.append(
            f"| {b} | {', '.join(f'{r['frames_per_s']:.1f}' for r in rs)} "
            f"| {med[b]:.1f} | "
            f"{', '.join(f'{r['frame_ms_p95']:.1f}' for r in rs)} | "
            f"{', '.join(f'{r['setup_s']:.1f}' for r in rs)} | "
            f"{max(r['memory_peak_bytes'] for r in rs) / 1e9:.2f} | "
            f"{all(r['correct'] for r in rs)} |")
    lines += ["", f"Chosen: B = {choice}, the smallest B within "
              f"{WITHIN:.0%} of the best median ({best:.1f} frames/s)."]
    return "\n".join(lines) + "\n", choice


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.sweep_lanes")
    ap.add_argument("--cell", default="kitti_pl.fleet")
    ap.add_argument("--lanes", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2_400_000_000)
    ap.add_argument("--out", default="build/lane_sweep.md")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    run.cache_env()
    if args.one is not None:
        print(json.dumps(one(args.cell, args.one, args.seconds, args.seed)))
        return 0
    rows = []
    for r in range(args.rounds):
        for b in args.lanes:
            proc = subprocess.run(
                [sys.executable, "-m", "vobench.sweep_lanes", "--cell",
                 args.cell, "--seconds", str(args.seconds), "--seed",
                 str(args.seed + 1000 * r + b), "--one", str(b)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], file=sys.stderr)
                return proc.returncode
            rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    text, _ = table(rows, args.lanes, run.card_line())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

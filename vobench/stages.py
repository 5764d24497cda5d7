"""The captured step's stage stamps in the traced slice.

The program marks the end of each stage of its VO step with a one-thread
kernel, `stage_stamp_kernel` (stvo_pl_tpu_torch/utils/profiling.py), that
a replay runs once the stage's work has finished: `begin`, `points`,
`lines`, `f2f`, `optimizer`, `keyframe`, six kernel nodes of the captured
graph.  Their starts in the profiler's trace bound the stages on the
device's clock: stage k of a replay lasts from stamp k - 1 to stamp k.
These readings are the traced slice's, with the profiler on, which
lengthens some stages (the optimizer's most; PERF.md §6); the program's
ring holds the same stamps for every replay of the window
(`python -m vobench.stage_window`).  A program without stamps (as before
they existed) leaves none in the trace, and nothing is read.
"""

from __future__ import annotations

import sys
from collections import defaultdict

STAMP = "stage_stamp_kernel"
NAMES = ("begin", "points", "lines", "f2f", "optimizer", "keyframe")


def replays(r) -> list | None:
    """[[Event] x 6] the stamps of each traced replay, in order; None where
    the trace holds none, or another number than 6 a traced step."""
    if r.trace is None or not r.steps_traced:
        return None
    stamps = sorted((e for e in r.trace.kernels if STAMP in e.name),
                    key=lambda e: e.ts)
    if not stamps:
        return None
    S = len(NAMES)
    if len(stamps) != S * r.steps_traced:
        print(f"[vobench] {len(stamps)} stage stamps traced, "
              f"{r.steps_traced} x {S} expected", file=sys.stderr)
        return None
    return [stamps[i:i + S] for i in range(0, len(stamps), S)]


def stage_ms(r, name: str) -> float | None:
    """Mean over the traced replays of the stage's device time, ms: from
    the stamp before it to its own."""
    rows = replays(r)
    if rows is None:
        return None
    k = NAMES.index(name)
    return sum(row[k].ts - row[k - 1].ts for row in rows) * 1e-3 / len(rows)


def short(kernel: str, width: int = 80) -> str:
    """A kernel's name without `void` and the namespaces `at::native::`
    and `(anonymous namespace)::`, cut to `width` characters."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(junk, "")
    return kernel[:width]


def breakdown(r) -> list | None:
    """[(stage, kernels per step, device ms per step, kernel ms per step,
    [(kernel, ms per step)] of its 3 longest)] for the five stages and,
    as `outside`, the traced kernels between one replay's `keyframe` and
    the next one's `begin` (the harness's copies, resets and packing)."""
    rows = replays(r)
    if rows is None:
        return None
    n = len(rows)
    bounds = [(NAMES[k], row[k - 1].ts, row[k].ts) for row in rows
              for k in range(1, len(NAMES))]
    bounds += [("outside", a[-1].ts, b[0].ts) for a, b in zip(rows, rows[1:])]
    out = []
    for name in NAMES[1:] + ("outside",):
        ivs = [(lo, hi) for s, lo, hi in bounds if s == name]
        inside = [e for e in r.trace.kernels if STAMP not in e.name
                  and any(lo <= e.ts < hi for lo, hi in ivs)]
        by_name: dict = defaultdict(float)
        for e in inside:
            by_name[short(e.name)] += e.dur * 1e-3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        steps = n if name != "outside" else max(n - 1, 1)
        out.append((name, len(inside) / steps,
                    sum(hi - lo for lo, hi in ivs) * 1e-3 / steps,
                    sum(e.dur for e in inside) * 1e-3 / steps, top))
    return out


def log_breakdown(r) -> None:
    """Print `breakdown` to standard error, one line a stage."""
    for name, kernels, wall, busy, top in breakdown(r) or ():
        print(f"[vobench] stage {name}: {kernels:.1f} kernels/step, "
              f"{wall:.3f} device ms/step, {busy:.3f} kernel ms/step; top "
              + "; ".join(f"{k} {v:.3f}" for k, v in top), file=sys.stderr)

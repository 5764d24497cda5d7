"""Stage stamps of the traced slice picked by name, for a step that stamps
other names than the six that vobench/stages.py reads: the one-lane step
that rectifies a rig's raw pair stamps `rectify` after `begin`
(`RECTIFIED`).  As there, the stamps' starts in the profiler's trace bound
the stages on the device's clock, and a trace with another number of
stamps a traced step than the names (a program without them) gives
nothing.
"""

from __future__ import annotations

import sys

from vobench.stages import STAMP

RECTIFIED = ("begin", "rectify", "points", "lines", "f2f", "optimizer",
             "keyframe")


def replays(r, names: tuple) -> list | None:
    """[[Event] x len(names)] the stamps of each traced replay, in order;
    None where the trace holds none, or another number a traced step."""
    if r.trace is None or not r.steps_traced:
        return None
    stamps = sorted((e for e in r.trace.kernels if STAMP in e.name),
                    key=lambda e: e.ts)
    if not stamps:
        return None
    S = len(names)
    if len(stamps) != S * r.steps_traced:
        print(f"[vobench] {len(stamps)} stage stamps traced, "
              f"{r.steps_traced} x {S} expected", file=sys.stderr)
        return None
    return [stamps[i:i + S] for i in range(0, len(stamps), S)]


def span_ms(r, names: tuple, start: str, end: str) -> float | None:
    """Mean over the traced replays of the device time from stamp `start`
    to stamp `end`, ms."""
    rows = replays(r, names)
    if rows is None:
        return None
    a, b = names.index(start), names.index(end)
    return sum(row[b].ts - row[a].ts for row in rows) * 1e-3 / len(rows)


def log_stages(r, names: tuple) -> None:
    """Each stage's mean device ms over the traced replays, to standard
    error."""
    if replays(r, names) is None:
        return
    print("[vobench] stages (device ms, traced mean): " + "  ".join(
        f"{b} {span_ms(r, names, a, b):.3f}"
        for a, b in zip(names, names[1:])), file=sys.stderr)

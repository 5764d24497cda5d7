"""The hand-written kernels' share of their roofline in the traced window:
the sum of their least times (vobench/roofline/: each launch's bytes and
operations from the shapes of its call, against the H100's peaks) over
the sum of their traced device times.  Only kernels that the cell's step
launches count; nothing is read where none is launched, or where the
trace holds another number of launches than the traced steps make."""

import sys

from vobench.reference.bounds import bound_ms
from vobench.registry import roofline_modules


def read(r):
    if r.trace is None or not r.steps_traced:
        return None
    bound = traced = 0.0
    for mod in roofline_modules():
        try:
            calls = mod.calls(r.vo, r.cam, r.lanes)
        except NotImplementedError as e:
            print(f"[vobench] {mod.ID}: {e}", file=sys.stderr)
            return None
        if not calls:
            continue
        events = [e for e in r.trace.kernels
                  if any(k in e.name for k in mod.KERNELS)]
        launches = sum(mod.KERNELS[0] in e.name for e in events)
        if launches != r.steps_traced * len(calls):
            print(f"[vobench] {mod.ID}: {launches} launches traced, "
                  f"{r.steps_traced} x {len(calls)} expected",
                  file=sys.stderr)
            return None
        bound += r.steps_traced * sum(bound_ms(b, o)[0] for b, o in calls)
        traced += sum(e.dur for e in events) * 1e-3
    return 100.0 * bound / traced if traced else None

"""Controls of a cell whose system rectifies a distorted rig's raw frames
(vobench/system_online.py): the readings that show the limits of
`correct` catch a rectification fault.  In each, the cell's raw frames
(made from the configuration's true calibration) go to a step built
without, or with the wrong, rectification.  One JSON line a run, as
`python -m vobench.controls` prints them; that module gives the cell's
sound readings and its other controls.

    python -m vobench.controls_rectify --cell euroc_pl.online \\
        [--control 3] [--seconds 30] [--variants no_rectify k1_off]

- `no_rectify`: the step built without the rectification, fed the raw
  pairs as they are.
- `k1_off`: the step's rectification made from the calibration with both
  eyes' k1 10% larger.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from vobench import registry, run
from vobench.system_online import RawOnline

VARIANTS = ("no_rectify", "k1_off")
K1_SCALE = 1.1


def build(cell: str, variant: str):
    w = registry.cell(registry.manifest(), cell)
    cfg = registry.config(w["config"])
    if variant == "no_rectify":
        return RawOnline(cfg, "cuda", rectify=False)
    if variant == "k1_off":
        raw = dict(cfg["raw"])
        for eye in ("Dl", "Dr"):
            raw[eye] = [raw[eye][0] * K1_SCALE] + list(raw[eye][1:])
        return RawOnline(cfg, "cuda", raw=raw)
    raise ValueError(f"unknown variant {variant!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.controls_rectify")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2_950_000_000)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args(argv)
    run.cache_env()
    print(f"[vobench] card {run.card_line()}", file=sys.stderr)
    for vi, variant in enumerate(args.variants):
        try:
            system = build(args.cell, variant)
            for k in range(args.control):
                seed = args.seed + 1000 * vi + 7 * k
                numbers: dict = {}
                row = dict(cell=args.cell, variant=variant, seed=seed)
                try:
                    out = run.execute(args.cell, seed, args.seconds, False,
                                      "cuda", system=system, sink=numbers,
                                      log=lambda m: None)
                    row.update(correct=out["correct"],
                               attempted=out["attempted"],
                               failed=out["failed"], numbers=numbers,
                               checks=out["checks"])
                except Exception as e:      # a control may crash: recorded
                    row.update(error=f"{type(e).__name__}: {e}",
                               where=traceback.format_exc()[-800:])
                print(json.dumps(row), flush=True)
            del system
        except Exception as e:              # the build of a control failed
            print(json.dumps(dict(cell=args.cell, variant=variant,
                                  error=f"{type(e).__name__}: {e}",
                                  where=traceback.format_exc()[-800:])),
                  flush=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

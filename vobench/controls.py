"""The readings that the limits of `correct` are set from (on a card): a
cell's system at the cell's own size and load, run over many seeds as the
program is configured (the lower readings) and over a few seeds with each
control (the upper readings), one JSON line per run with every number the
comparison computes.

    python -m vobench.controls --cell kitti_pl.fleet [--sound 12] \\
        [--control 3] [--seconds 30] [--variants ...]

A cell of `vobench/pending/` is taken from there.

Variants (vobench/limits/*.json names which one each limit is held
against):

- `sound`: the program as the configuration states it.
- `bf16_state`: the state the step carries from frame to frame held in
  bfloat16 (every float tensor of it rounded after each step), the
  precision below the configuration's float32 for that state.
- `no_lines`: the step with its line half dropped (`has_lines: false`),
  breaking the point-and-line configuration's guarantee.
- `kf_dropped`: the keyframe flag left false where the step produces it.
- `ba_tf32` (cells with a back end): the plain reference's back end
  (vobench/reference/window_ba.py) in the program's place, computed in
  float32 with every product's operands in TF32, the precision below the
  float32 without TF32 that the program's bundle adjustment states.
- `ba_unrefined` (cells with a back end): a back end that closes the same
  windows and returns their input poses (no Gauss-Newton step).

The system is built once per variant and reused over its seeds; each seed
renders its own pool.  A run that raises is reported as such.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from vobench import registry, run
from vobench.reference import window_ba
from vobench.system import map_tree

VARIANTS = ("sound", "bf16_state", "no_lines", "kf_dropped", "ba_tf32",
            "ba_unrefined")


class Wrapped:
    """A system whose step's outputs pass through `post(state, telem)`."""

    def __init__(self, inner, post):
        self._inner, self._post = inner, post

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self, state, imgs_l, imgs_r):
        return self._post(*self._inner.step(state, imgs_l, imgs_r))


class WithBackEnd:
    """A system whose back end is the reference's, built by `make()`."""

    def __init__(self, inner, make):
        self._inner, self.new_ba = inner, make

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TF32BackEnd(window_ba.BackEnd):
    """The reference's back end in float32 with every product's operands
    read in TF32 (emulated: a tensor core is free to leave the small
    products of the refinement in float32 even with TF32 allowed)."""

    def observe(self, *args):
        with window_ba.products_in(window_ba.tf32):
            return super().observe(*args)


def bf16_state(state, telem):
    return map_tree(lambda x: x.to(torch.bfloat16).to(x.dtype)
                    if x.is_floating_point() else x, state), telem


def kf_dropped(state, telem):
    return state, telem._replace(is_kf=torch.zeros_like(telem.is_kf))


def build(cell: str, variant: str, mix_changes: dict | None = None):
    w = registry.cell(registry.manifest(), cell)
    cfg = registry.config(w["config"])
    mix = dict(registry.traffic(w["traffic"]), **(mix_changes or {}))
    if variant == "no_lines":
        cfg = dict(cfg, vo={**cfg["vo"], "has_lines": False})
    system = registry.driver(mix["kind"]).build(cfg, mix, "cuda")
    if variant == "bf16_state":
        system = Wrapped(system, bf16_state)
    elif variant == "kf_dropped":
        system = Wrapped(system, kf_dropped)
    elif variant in ("ba_tf32", "ba_unrefined"):
        from vobench.reference.render import Camera
        cam = Camera(*(cfg["camera"][k] for k in Camera._fields))
        s = window_ba.Settings.of(cfg["vo"], mix["ba"])
        if variant == "ba_tf32":
            system = WithBackEnd(system, lambda: TF32BackEnd(
                cam, s, torch.float32, "cuda"))
        else:
            system = WithBackEnd(system, lambda: window_ba.BackEnd(
                cam, s._replace(n_iters=0), device="cuda"))
    return system


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.controls")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=2_900_000_000)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    args = ap.parse_args(argv)
    run.cache_env()
    man = registry.manifest()
    if args.cell not in {w["name"] for w in man["workloads"]}:
        man = registry.with_pending(man, args.cell)     # vobench/pending/
        registry.manifest = lambda: man
    w = registry.cell(man, args.cell)
    has_lines = registry.config(w["config"])["vo"]["has_lines"]
    mix = registry.traffic(w["traffic"])
    print(f"[vobench] card {run.card_line()}", file=sys.stderr)
    for vi, variant in enumerate(args.variants):
        if ((variant == "no_lines" and not has_lines)
                or (variant.startswith("ba_") and "ba" not in mix)):
            continue
        n = args.sound if variant == "sound" else args.control
        try:
            system = build(args.cell, variant)
            for k in range(n):
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
                               metrics={k2: v["value"] for k2, v
                                        in out["metrics"].items()})
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

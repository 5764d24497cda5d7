"""A second witness for the back end's comparison (on a card): each BA
window of the pending online cell (vobench/pending/), refined by the
program's captured refiner as `WindowedBA` runs it, by the refiner's eager
body on the device and on the CPU, and by the plain reference
(vobench/reference/window_ba.py) in float64 and float32, all from the
inputs the program's window had.  One JSON line per window: each route's
largest keyframe-position gap to the float64 reference, each route's
choice of the joint (point-and-line) solution, and the statistics that
choice is made on (the joint solution's point cost over chi2_tol times the
points-only one's, the two solutions' largest disagreement in m and deg),
by the program's eager route and by the reference.

    python -m vobench.witness_ba --seed <n> [--frames 120] [--device cpu]

No cell runs it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vobench import registry, run
from vobench.reference import render, window_ba


def _gap(A, B) -> float:
    return float(np.linalg.norm(np.asarray(A, np.float64)[:, :3, 3]
                                - np.asarray(B, np.float64)[:, :3, 3],
                                axis=-1).max())


def program_choice(win, cam, cfg, ba: dict) -> dict:
    """The statistics `refine_window_auto` chooses on, by the program."""
    from stvo_pl_tpu_torch.ops import se3
    from stvo_pl_tpu_torch.parallel import ba as pba
    from stvo_pl_tpu_torch.parallel import window as W
    prob = W.build_problem_tracks(win, cam, cfg)
    cw0 = se3.inverse_se3(win.Tfw)
    pp = prob._replace(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    cw_p = pba.ba_solve(cw0, pp, cam, n_iters=ba["n_iters"])[0]
    cw_j = pba.ba_solve(cw0, prob, cam, n_iters=ba["n_iters"])[0]
    chi_p = float(pba.point_chi2(cw_p, pp, cam)[0])
    chi_j = float(pba.point_chi2(cw_j, pp, cam)[0])
    D = se3.mm(cw_j, se3.inverse_se3(cw_p)).double()
    return _stats(chi_p, chi_j, D, ba)


def reference_choice(T_in, pts, lns, cam, s) -> dict:
    """The same statistics by the float64 reference."""
    p = window_ba.build(T_in, pts, lns, cam, s)
    cw0 = window_ba.inverse(T_in)
    pp = p._replace(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    cw_p, _ = window_ba.solve(cw0, pp, cam, s.n_iters, s.damping)
    cw_j, _ = window_ba.solve(cw0, p, cam, s.n_iters, s.damping)
    D = cw_j @ window_ba.inverse(cw_p)
    return _stats(float(window_ba.point_cost(cw_p, pp, cam)),
                  float(window_ba.point_cost(cw_j, pp, cam)), D,
                  s._asdict())


def _stats(chi_p, chi_j, D, ba) -> dict:
    ratio = chi_j / (ba["chi2_tol"] * chi_p)
    dis_t = float(D[:, :3, 3].norm(dim=-1).max())
    dis_r = float(window_ba._angle_deg(D[:, :3, :3]).max())
    joint = (ratio <= 1.0 and dis_t <= ba["max_disagree_t"]
             and dis_r <= ba["max_disagree_r"])
    return dict(chi_ratio=ratio, disagree_m=dis_t, disagree_deg=dis_r,
                joint=joint)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vobench.witness_ba")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.cache_env()
    from stvo_pl_tpu_torch.models.backend import WindowedBA
    from stvo_pl_tpu_torch.parallel import window as W
    from vobench.system import Online

    cfg = registry.config("kitti_pl")
    mix = registry.traffic("online_ba")
    cam = render.Camera(*(cfg["camera"][k] for k in render.Camera._fields))
    T = mix["seq_frames"]
    passes = -(-args.frames // T)
    left, right, _ = render.render_pool(args.seed, passes, cam, mix["scene"],
                                        T, mix["speed_m_per_frame"],
                                        args.device)
    system = Online(cfg, mix["ba"], args.device)
    s = window_ba.Settings.of(cfg["vo"], mix["ba"])
    windows = []

    class Witnessed(WindowedBA):
        def _refine(self):
            inputs = (self.stack_window(),
                      np.stack([e[1] for e in self._ring]),
                      [e[3] for e in self._ring], [e[4] for e in self._ring])
            out = super()._refine()
            windows.append(inputs + (out,))
            return out

    state = ba = None
    for k in range(args.frames):
        f = k % T
        if f == 0:
            state = system.fresh()
            ba = Witnessed.__new__(Witnessed)
            ba.__dict__.update(system.new_ba().__dict__)
        state, telem = system.step(state, left[k], right[k])
        system.observe(ba, f, telem.Tfw.reshape(4, 4).cpu().numpy(),
                       bool(telem.is_kf), state)
    if args.device == "cuda":
        torch.cuda.synchronize()
    refiner = ba.refiner(True)
    kw = dict(n_iters=mix["ba"]["n_iters"], chi2_tol=s.chi2_tol,
              max_disagree_t=s.max_disagree_t,
              max_disagree_r=s.max_disagree_r)

    def stack(sets, dtype):
        return {f: (x.to(dtype) if x.is_floating_point() else x) for f, x in
                window_ba._stack(sets).items()}

    for i, (win, T_in, pts, lns, out) in enumerate(windows):
        cpu = W.KeyframeWindow(*[x.cpu() if torch.is_tensor(x)
                                 else type(x)(*[y.cpu() for y in x])
                                 for x in win])
        T64 = torch.from_numpy(T_in).to(args.device)
        ref = window_ba.refine(T64, stack(pts, torch.float64),
                               stack(lns, torch.float64), cam, s).cpu()
        ref32 = window_ba.refine(T64.float(), stack(pts, torch.float32),
                                 stack(lns, torch.float32), cam, s)
        routes = dict(captured=refiner(win), eager=refiner.fn(win),
                      eager_cpu=W.refine_window_auto(cpu, system.cam,
                                                     system.cfg, **kw))
        row = dict(window=i, skipped=out is None,
                   gap_program=None if out is None else _gap(out[1], ref),
                   gap_ref32=_gap(ref32.double().cpu(), ref),
                   correction=_gap(ref, T_in))
        for name, r in routes.items():
            row[f"gap_{name}"] = _gap(r[0].double().cpu(), ref)
            row[f"joint_{name}"] = bool(r[3])
        row["program"] = program_choice(win, system.cam, system.cfg,
                                        mix["ba"])
        row["reference"] = reference_choice(
            T64, stack(pts, torch.float64), stack(lns, torch.float64), cam, s)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The system under test: the entry points of `stvo_pl_tpu_torch` that a
cell's window drives, built from a configuration file.  The only module of
the benchmark that imports the program.

- `Fleet`: B lanes through `parallel/batched.compile_vo_step`, the
  captured batched step (a CUDA graph), with lane resets on the device.
- `Online`: one lane through `models/frontend.compile_vo_step` and a
  `models/backend.WindowedBA` fed as the program's CLI (`cli.run`) feeds
  it.

Both hand the telemetry to the host as one float32 row per lane
(`TELEMETRY` columns), as the CLI packs it.
"""

from __future__ import annotations

import torch

# columns of a packed telemetry row, after the 16 entries of Tfw
TELEMETRY = ("good", "is_kf", "n_points", "n_inliers_pt", "n_lines",
             "n_inliers_ls", "err_norm")
WIDTH = 16 + len(TELEMETRY)


def leaves(tree) -> list:
    """The tensors of a nested NamedTuple, in order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_tree(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*[map_tree(fn, t) for t in tree])
    return fn(tree)


def camera(config: dict):
    from stvo_pl_tpu_torch.ops.camera import StereoCamera
    c = config["camera"]
    return StereoCamera(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                        b=c["b"], width=c["width"], height=c["height"])


def vo_config(config: dict):
    """The program's VOConfig from the file's `vo` table (its keys are
    VOConfig's fields; `per_direction` is a step argument)."""
    from stvo_pl_tpu_torch.config import config_from_mapping
    return config_from_mapping({k: v for k, v in config["vo"].items()
                                if k != "per_direction"})


def pack(telem, lanes: int) -> torch.Tensor:
    """[lanes, WIDTH] float32: Tfw and the TELEMETRY counters (counts are
    far below 2^24, so exact)."""
    return torch.cat([telem.Tfw.reshape(lanes, 16).float()]
                     + [getattr(telem, f).reshape(lanes, 1).float()
                        for f in TELEMETRY], dim=1)


class _Captured:
    """What both systems share: a fresh copy of the initial state, the
    packed telemetry, and the captured graph of the step."""

    pack_width = WIDTH
    lanes: int
    init: tuple
    step: object

    def fresh(self):
        return map_tree(torch.clone, self.init)

    def pack(self, telem) -> torch.Tensor:
        return pack(telem, self.lanes)

    def graph(self):
        """The captured graph of the step (on CUDA, after the first
        call)."""
        (prog,) = self.step.programs.values()
        return prog.graph


class Fleet(_Captured):
    """B lanes of the captured batched VO step."""

    def __init__(self, config: dict, lanes: int, device):
        from stvo_pl_tpu_torch.parallel import batched
        self.lanes = lanes
        self.cam = camera(config)
        self.cfg = vo_config(config)
        self.step = batched.compile_vo_step(
            self.cam, self.cfg, lanes,
            per_direction=config["vo"].get("per_direction", False),
            device=device)
        self.init = batched.init_batched_state(self.cfg, lanes, device)

    def reset(self, state, idx: torch.Tensor):
        """Put the lanes `idx` (a device index tensor) of `state` back to
        their initial values, in place and on the device."""
        for x, x0 in zip(leaves(state), leaves(self.init)):
            x.index_copy_(0, idx, x0.index_select(0, idx))


class Online(_Captured):
    """One lane of the captured VO step and the windowed BA behind it."""

    lanes = 1

    def __init__(self, config: dict, ba: dict, device):
        from stvo_pl_tpu_torch.models import frontend
        self.cam = camera(config)
        self.cfg = vo_config(config)
        self.device = device
        self.ba = ba
        self.step = frontend.compile_vo_step(
            self.cam, self.cfg,
            per_direction=config["vo"].get("per_direction", False),
            device=device)
        self.init = frontend.init_state(self.cfg, device=device)
        self._refiners: dict = {}

    def new_ba(self):
        """A fresh back end (empty keyframe ring, no correction), sharing
        the refiners that earlier back ends captured: each sequence starts
        its own, as each run of the CLI does."""
        from stvo_pl_tpu_torch.models.backend import WindowedBA
        s = self.ba
        ba = WindowedBA(self.cam, self.cfg, window=s["window"],
                        n_iters=s["n_iters"], force_kf_every=s["kf_every"],
                        max_correction=s["max_correction"],
                        max_rot_correction=s["max_rot_correction"],
                        chi2_tol=s["chi2_tol"],
                        max_disagree_t=s["max_disagree_t"],
                        max_disagree_r=s["max_disagree_r"],
                        device=self.device)
        ba._refiners = self._refiners
        return ba

    @staticmethod
    def keyframe_sets(state):
        """The point and line sets that `observe` hands the back end."""
        return state.prev_points, state.prev_lines

    @staticmethod
    def observe(ba, frame: int, Tfw, is_kf: bool, state):
        """`WindowedBA.observe` as `cli.run` calls it."""
        return ba.observe(frame, Tfw, frame > 0 and is_kf,
                          state.prev_points, state.prev_lines)

"""The system of a cell whose rig is distorted: one lane through
`models/frontend.compile_vo_step` built with the rig's rectification, so
that the captured step takes the raw pair and rectifies it inside its
graph, as the program's CLI (`cli.run`) builds it for a calibration with
maps.  The calibration goes through the program's own entry
(`utils/dataset.calib_from_yaml`) from the configuration's `raw` table,
the dataset file's `cam0` block.  A module beside vobench/system.py,
which it shares the telemetry and the state handling with.
"""

from __future__ import annotations

from vobench.system import _Captured, vo_config

CAMERA = ("fx", "fy", "cx", "cy", "b", "width", "height")
CAMERA_TOL = 1e-9


def cam0(raw: dict, camera: dict) -> dict:
    """The dataset file's `cam0` block of a configuration's `raw` table."""
    block = {k: raw[k] for k in ("Kl", "Kr", "Dl", "Dr", "R", "t")}
    block.update(cam_model="fisheye" if raw.get("model") == "equidistant"
                 else "Pinhole", cam_width=camera["width"],
                 cam_height=camera["height"])
    return block


class RawOnline(_Captured):
    """One lane of the captured VO step that rectifies the rig's raw
    pairs.  `raw`: the calibration the step is built from, where it is not
    the configuration's own (a control's); `rectify=False` builds the step
    without the rectification (a control's, or a rig that is already
    rectified).  `config` stays the configuration's: the cell's raw
    frames are made from it."""

    lanes = 1

    def __init__(self, config: dict, device, raw: dict | None = None,
                 rectify: bool = True):
        from stvo_pl_tpu_torch.models import frontend
        from stvo_pl_tpu_torch.utils.dataset import calib_from_yaml
        self.config = config
        calib = calib_from_yaml(dict(cam0=cam0(raw or config["raw"],
                                               config["camera"])))
        want = config["camera"]
        for k in CAMERA:
            if abs(getattr(calib.cam, k) - want[k]) > CAMERA_TOL:
                raise ValueError(f"the configuration's rectified camera "
                                 f"has {k} {want[k]!r}, its raw calibration "
                                 f"gives {getattr(calib.cam, k)!r}")
        self.cam = calib.cam
        self.cfg = vo_config(config)
        self.rectification = None
        if rectify:
            from stvo_pl_tpu_torch.ops.camera import rectify_taps
            self.rectification = rectify_taps(
                calib.map_l, calib.map_r, (self.cam.height, self.cam.width),
                device)
        self.step = frontend.compile_vo_step(
            self.cam, self.cfg,
            per_direction=config["vo"].get("per_direction", False),
            device=device, rectify=self.rectification)
        self.init = frontend.init_state(self.cfg, device=device)

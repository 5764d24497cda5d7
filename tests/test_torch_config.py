"""The port's VOConfig against the JAX package's: same fields, types and
defaults, and the same result from every shipped YAML preset."""

import dataclasses
import glob
import os
import warnings

import pytest
import torch

from stvo_pl_tpu import config as jcfg
from stvo_pl_tpu_torch import config as tcfg

torch.set_num_threads(1)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
PRESETS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_fields_types_defaults_match():
    assert _fields(tcfg.VOConfig) == _fields(jcfg.VOConfig)
    j, t = jcfg.VOConfig(), tcfg.VOConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.point_capacity, t.line_capacity) == (j.point_capacity,
                                                    j.line_capacity)
    j0, t0 = j.replace(lsd_nfeatures=0), t.replace(lsd_nfeatures=0)
    assert t0.line_capacity == j0.line_capacity


def test_presets_found():
    assert len(PRESETS) >= 5, PRESETS


@pytest.mark.parametrize("path", PRESETS, ids=os.path.basename)
def test_load_config_agrees(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jcfg.load_config(path)
        t = tcfg.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_mapping_coercion_and_fallbacks(tmp_path):
    m = {"orb_nfeatures": "900", "min_disp": 2, "has_lines": 0,
         "not_a_field": 1}
    assert (dataclasses.asdict(tcfg.config_from_mapping(m))
            == dataclasses.asdict(jcfg.config_from_mapping(m)))
    missing = str(tmp_path / "missing.yaml")
    assert tcfg.load_config(missing) == tcfg.VOConfig()
    assert tcfg.load_config(None) == tcfg.VOConfig()
    with pytest.raises(ValueError):
        tcfg.config_from_mapping({"orb_wta_k": 5})
    with pytest.warns(UserWarning):
        tcfg.config_from_mapping({"lsd_n_bins": 512})

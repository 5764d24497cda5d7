"""BENCHMARK.json against the contract's rules, and the harness finding a
dropped-in cell, configuration, traffic mix and per-layer metric by name
alone."""

import json
import re
import shutil

import pytest

from vobench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def man():
    return registry.manifest()


def test_top_level_keys_and_paths(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["vobench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell at run_seconds + 60
    # each, 2 x 90 s of compilation a cell, 1200 s spare
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("vobench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    every = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(every) == len(set(every)) and len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(man)) <= 64 * 1024


def test_every_metric_and_cell_is_wired(man):
    cells = {w["name"] for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    assert configs == {w["config"] for w in man["workloads"]}
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for w in man["workloads"]:
        e2e, layer = registry.metrics_of(man, w["name"])
        e2e_names = {m["name"] for m in e2e}
        assert "setup_s" in e2e_names and len(e2e_names) >= 2 and layer
        for m in layer:             # what it moves, the cell reports
            assert m["moves"] in e2e_names
        cfg = registry.config(w["config"])
        assert cfg["name"] == w["config"] and len(cfg["source"]) <= 200
        mix = registry.traffic(w["traffic"])
        assert hasattr(registry.driver(mix["kind"]), "run")
        assert registry.limits(w["name"])
    for m in man["per_layer"]:
        assert callable(registry.reader(m["name"]).read)
    for c in man["configs"]:
        assert registry.config(c["name"])["reduced"] == c["reduced"]


def test_a_dropped_in_cell_is_found_without_edits(tmp_path, man):
    base = tmp_path / "vobench"
    shutil.copytree(registry.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = registry.config("kitti_pl")
    cfg["name"] = "kitti_pl_wide"
    (base / "configs" / "kitti_pl_wide.json").write_text(json.dumps(cfg))
    mix = registry.traffic("fleet")
    mix["lanes"] = 16
    (base / "traffic" / "fleet_b16.json").write_text(json.dumps(mix))
    (base / "metrics" / "steps_traced.fleet16.py").write_text(
        "def read(r):\n    return r.steps_traced or None\n")
    (base / "limits" / "kitti_pl_wide.fleet16.json").write_text(
        json.dumps({"ate_m": {"limit": 1.0}}))
    new = dict(man)
    new["workloads"] = man["workloads"] + [dict(
        name="kitti_pl_wide.fleet16", config="kitti_pl_wide",
        traffic="fleet_b16", chips=1, why="a dropped-in cell")]
    new["per_layer"] = man["per_layer"] + [dict(
        name="steps_traced.fleet16", unit="steps", better="higher",
        source="program_counter", layer="vobench", moves="frames_per_s",
        workloads=["kitti_pl_wide.fleet16"])]
    new["end_to_end"] = [dict(m, workloads=m["workloads"]
                              + ["kitti_pl_wide.fleet16"])
                         if "workloads" in m else m
                         for m in man["end_to_end"]]
    e2e, layer = registry.metrics_of(new, "kitti_pl_wide.fleet16")
    assert {m["name"] for m in e2e} == {"frames_per_s", "frame_ms_p95",
                                        "setup_s"}
    assert [m["name"] for m in layer] == ["steps_traced.fleet16"]
    assert registry.config("kitti_pl_wide", base)["name"] == "kitti_pl_wide"
    assert registry.traffic("fleet_b16", base)["lanes"] == 16
    assert registry.limits("kitti_pl_wide.fleet16", base) == {"ate_m": 1.0}
    reader = registry.reader("steps_traced.fleet16", base)
    assert reader.read(type("R", (), {"steps_traced": 6})()) == 6
    assert registry.driver("fleet", base).run
    # the existing cells keep their metrics
    def names(m, cell):
        return [[x["name"] for x in part] for part in registry.metrics_of(
            m, cell)]

    for w in man["workloads"]:
        assert names(new, w["name"]) == names(man, w["name"])


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (registry.HERE / "pending").glob("*.json")))
def test_a_pending_cell_meets_the_rules(man, name):
    ext = registry.with_pending(man, name)
    assert name in {w["name"] for w in ext["workloads"]}
    test_names_units_and_keys(ext)
    test_every_metric_and_cell_is_wired(ext)

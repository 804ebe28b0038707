"""BENCHMARK.json against the contract's shape, and the harness finding
every cell, configuration and metric by name, a new cell included."""

import json
import os
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load()


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_found_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in names
            assert callable(spec.metric_reader(m["name"]))
        assert cell.traffic["limits"] and cell.config["MODEL"]["RENDERER"]


def test_metric_layers_agree(bench):
    """Metrics of one layer name it alike; every reader names its layer."""
    for m in bench["per_layer"]:
        path = os.path.join(spec.HERE, "metrics", f"{m['name']}.py")
        with open(path) as f:
            assert f"Layer: {m['layer']}." in f.read(), m["name"]


def test_a_new_cell_is_files_only(bench, tmp_path):
    """A cell added as a traffic file and an entry is found; nothing that
    is there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark")
    b = json.loads(json.dumps(bench))
    b["workloads"].append({"name": "neus_dtu.train_b2", "config": "neus_dtu",
                           "traffic": "train_b2", "chips": 1, "why": "a new mix"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    with open(root / "benchmark" / "workloads" / "neus_dtu.train.json") as f:
        t = json.load(f)
    t["n_rays"] = 2048
    with open(root / "benchmark" / "workloads" / "neus_dtu.train_b2.json", "w") as f:
        json.dump(t, f)
    cell = spec.Cell(spec.load(str(root)), "neus_dtu.train_b2", str(root),
                     str(root / "benchmark" / "workloads"))
    assert cell.traffic["n_rays"] == 2048 and cell.config["MODEL"]["RENDERER"]["TYPE"] == "NeuS"

"""BENCHMARK.json against the benchmark's contract, and finding a cell's
pieces by name (also ones added in a temporary directory)."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
# the configuration keys that are widths, which `reduced` may never name
WIDTHS = {"d_model", "d_inner", "num_heads", "d_input", "conv_channels",
          "conv_kernel", "d_joint", "vocab_size"}


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert os.path.exists(os.path.join(ROOT, bench["command"][1]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_workloads(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:        # a departure, never a width
            assert NAME.match(key) and key not in WIDTHS
            assert not key.endswith(("_dim", "_rank"))
            assert key in cfg["assumed"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                           cfg["reference"] + ".py"))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for folder, name in (("traffic", w["traffic"] + ".json"),
                             ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(ROOT, "benchmark", folder,
                                               name))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for w in cells:
        cell = harness.Cell(w)
        mine = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer()


@pytest.mark.parametrize("workload", ["st_train_b128k", "st_serve_joint_c64",
                                      "conformer_train_b128k"])
def test_cell_pieces_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["kind"] in ("train", "serve")
    assert hasattr(cell.driver, "run")
    assert hasattr(cell.reference, "param_spec")
    for m in cell.per_layer():
        assert callable(cell.module("metrics", m["name"]).read)
    assert set(cell.limits) <= {"loss_gap", "grad_gap", "grad_geo",
                                "change_gap", "score_gap", "best_gap"}


def test_new_config_traffic_and_metric_found_without_editing(tiny):
    cell = tiny("tiny_train")
    with open(os.path.join(cell.here, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['steps'])\n")
    bench_path = os.path.join(cell.root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "data loader",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["tiny_train"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = harness.Cell("tiny_train", root=cell.root, here=cell.here)
    assert cell.config["name"] == "tiny"
    assert cell.traffic["utterances"] == 60
    got = cell.read_per_layer({"kind": "train", "steps": [[(100, 3)]] * 4,
                               "config": cell.config["model"],
                               "window_s": 1.0, "loader_wait_s": 0.004})
    assert got["steps_seen"] == {"value": 4.0, "unit": "steps"}
    assert got["loader_wait_ms"]["value"] == pytest.approx(1.0)
    assert "flash_roofline.train" not in got      # nothing to read


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no_such_cell")

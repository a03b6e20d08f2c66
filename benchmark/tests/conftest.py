"""Small cells for the CPU tests: a copy of benchmark/ in a temporary
directory with a tiny configuration (the published layer kinds at widths
a test can hold, float32 so the CPU's plain kernels match the
reference), a tiny training mix and a tiny serving mix, each a new
workload found by name like any other."""

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = dict(d_model=32, d_inner=64, num_heads=2, num_enc_layers=2,
                  num_dec_layers=2, vocab_size=40, conv_kernel=7,
                  conv_channels=[4, 8], dtype="float32")
TINY_TRAIN = dict(utterances=60, batch_frames=1500, num_buckets=2,
                  frames={"median": 120, "sigma": 0.35, "min": 70,
                          "max": 250}, traced_steps=2)
TINY_SERVE = dict(requests=24, clients=4, lead_s=1.0, check_sample=16,
                  traced_s=0.5,
                  frames={"median": 150, "sigma": 0.35, "min": 70,
                          "max": 250},
                  server={"batch_size": 4, "bucket_frames": [128, 256],
                          "window_ms": 15},
                  decode={"mode": "joint", "beam": 3, "max_len": 10,
                          "ctc_weight": 0.3, "maxlenratio": 0.125})


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny(tmp, encoder="transformer", dtype="float32"):
    """tmp/BENCHMARK.json + tmp/benchmark/ with the cells tiny_train and
    tiny_serve added (the limits are those of the real cells they stand
    for) -> tmp."""
    here = os.path.join(tmp, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = _load(os.path.join(here, "configs",
                             "speech_transformer_aishell.json"))
    cfg["name"] = "tiny"
    cfg["model"].update(TINY_MODEL, encoder_type=encoder, dtype=dtype)
    _dump(cfg, os.path.join(here, "configs", "tiny.json"))
    train = _load(os.path.join(here, "traffic", "train_b128k.json"))
    train.update(copy.deepcopy(TINY_TRAIN))
    _dump(train, os.path.join(here, "traffic", "tiny_train.json"))
    serve = _load(os.path.join(here, "traffic", "serve_joint_c64.json"))
    serve.update(copy.deepcopy(TINY_SERVE))
    _dump(serve, os.path.join(here, "traffic", "tiny_serve.json"))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for cell, real in (("tiny_train", "st_train_b128k"),
                       ("tiny_serve", "st_serve_joint_c64")):
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": cell, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
        shutil.copy(os.path.join(here, "limits", real + ".json"),
                    os.path.join(here, "limits", cell + ".json"))
    _dump(bench, os.path.join(tmp, "BENCHMARK.json"))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    """A function: tiny(workload, encoder=, dtype=) -> harness.Cell."""
    from benchmark import harness

    def cell(workload, **kw):
        root = make_tiny(str(tmp_path / workload), **kw)
        return harness.Cell(workload, root=root,
                            here=os.path.join(root, "benchmark"))
    return cell

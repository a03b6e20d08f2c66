"""The run's last line and its exits."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness


def test_result_line_keys_and_the_checks_last():
    checks = [("loss_gap", 1e-4, 5e-4), ("grad_gap", 0.01, 0.05)]
    line = harness.result_line(True, 10, 0, {"setup_s": {"value": 1.5,
                                                          "unit": "s"}},
                               {"platform": "gpu", "kind": "x", "count": 1,
                                "memory_peak_bytes": 5}, checks,
                               {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checked"]
    assert out["checked"]["grad_gap"] == {"value": 0.01, "limit": 0.05}
    assert "\n" not in line


@pytest.mark.parametrize("value,ok", [(1e-4, True), (5e-4, True),
                                      (6e-4, False), (float("nan"), False),
                                      (float("inf"), False)])
def test_judge(value, ok):
    assert harness.judge([("loss_gap", value, 5e-4)]) is ok


def test_checks_printed_beside_their_limits(capsys):
    harness.print_checks([("score_gap", 0.5, 0.1)], stream=sys.stdout)
    assert capsys.readouterr().out.strip() == \
        "check score_gap: 0.5 (limit 0.1) FAILED"


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "st_train_b128k", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    tmp_path / "benchmark")
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert last["device"]["platform"] == "gpu"

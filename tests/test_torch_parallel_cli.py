"""The port's CLIs on several ranks, on the CPU (gloo): the trainer's
--num-devices and its COORDINATOR_ADDRESS launch, and recognize --dp.

hybrid_dev on 8 synthetic utterances for 2 epochs at --batch-size 2 (so
one rank and two read the same batches): the 2-rank runs end at the
1-rank run's cv loss within 1e-2 relative (the bound of tpu_asr's own
multi-host test, tests/integration/test_multihost.py); rank 0 alone
wrote the metrics and the checkpoints; a single process restores the
2-rank checkpoint and decodes with it, and recognize --dp 2 writes the
same hypotheses.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_asr_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
TRAIN = ["--preset", "hybrid_dev", "--synthetic", "8", "--epochs", "2",
         "--batch-size", "2", "--device", "cpu"]
EPOCHS = 2


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run(module, argv, **env):
    return subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO,
                            env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(*procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 1-rank, the --num-devices 2 and the two-process
    COORDINATOR_ADDRESS training runs, side by side."""
    d = tmp_path_factory.mktemp("parallel_cli")
    port = free_port()
    coord = dict(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2")
    procs = {
        "one": [_run("tpu_asr_torch.train",
                     TRAIN + ["--save-folder", str(d / "one")])],
        "spawn": [_run("tpu_asr_torch.train",
                       TRAIN + ["--save-folder", str(d / "spawn"),
                                "--num-devices", "2"])],
        "coordinator": [_run("tpu_asr_torch.train",
                             TRAIN + ["--save-folder", str(d / "coord")],
                             PROCESS_ID=str(r), **coord) for r in (0, 1)],
    }
    errs = {k: "".join(e for _, _, e in _wait(*v)) for k, v in procs.items()}
    folders = {"one": d / "one", "spawn": d / "spawn",
               "coordinator": d / "coord"}
    return folders, errs, d


def _cv(folder):
    lines = [json.loads(x) for x in open(folder / "metrics.jsonl")]
    return [m for m in lines if m.get("phase") == "cv"]


@pytest.mark.parametrize("launch", ["spawn", "coordinator"])
def test_two_ranks_train_like_one(runs, launch):
    folders, errs, _ = runs
    assert errs[launch].count("gloo on cpu") == 2
    one, two = _cv(folders["one"]), _cv(folders[launch])
    # rank 0 alone wrote: one cv line an epoch, as the 1-rank run
    assert len(two) == len(one) == EPOCHS
    assert [m["step"] for m in two] == [m["step"] for m in one]
    want = one[-1]["loss"]
    assert abs(two[-1]["loss"] - want) <= 1e-2 * max(1.0, abs(want))
    names = sorted(os.listdir(folders[launch]))
    assert names == sorted(os.listdir(folders["one"]))
    assert [n for n in names if n.endswith(".tmp")] == []


def _recognize(ckpt, manifest, out, *extra):
    return _run("tpu_asr_torch.recognize",
                ["--ckpt", str(ckpt), "--manifest", str(manifest),
                 "--mode", "joint", "--beam", "3", "--max-len", "10",
                 "--output", str(out), "--device", "cpu", *extra])


def test_two_rank_checkpoint_restores_and_decodes(runs):
    """One process restores the 2-rank checkpoint (full weights) and
    decodes with it; recognize --dp 2 on it writes the same hypotheses,
    and only its rank 0 prints the summary."""
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.train.checkpoints import Checkpointer
    folders, _, d = runs
    ck = Checkpointer(str(folders["spawn"]))
    state = ck.restore()
    one = Checkpointer(str(folders["one"])).restore()
    assert state["model"].keys() == one["model"].keys()
    for k, v in one["model"].items():
        assert state["model"][k].shape == v.shape, k
    manifest = d / "cv.jsonl"
    write_synthetic_manifest(str(manifest), 6, 64)
    outs = _wait(_recognize(folders["spawn"], manifest, d / "hyp1.jsonl"),
                 _recognize(folders["spawn"], manifest, d / "hyp2.jsonl",
                            "--dp", "2"))
    summaries = [[json.loads(x) for x in out.splitlines() if x]
                 for _, out, _ in outs]
    assert [len(s) for s in summaries] == [1, 1]
    assert summaries[0][0]["n_utts"] == summaries[1][0]["n_utts"] == 6
    assert open(d / "hyp1.jsonl").read() == open(d / "hyp2.jsonl").read()

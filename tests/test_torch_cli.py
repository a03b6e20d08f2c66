"""The port's CLIs on the CPU: train_lm (one step against a tpu_asr step
from the same params, rtol 1e-4; its batches against bin/train_lm.py's),
a drive of train -> train_lm -> recognize --lm-ckpt -> score on a tiny
synthetic set, serve with --dict --lm-ckpt --restore latest, and the
trainer flags --dict, --dtype, --specaug-warp, --print-freq,
--debug-nans and --profile-dir."""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_asr.ops.losses import label_smoothing_loss as jax_ls_loss
from tpu_asr.train.optim import make_optimizer
from tpu_asr_torch.train.optim import NoamAdam
from tpu_asr_torch.train_lm import LMTrainStep, make_batches
from torch_port_util import lm_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_VOCAB = 12


def _reference_train_lm():
    """bin/train_lm.py as a module (its make_batches is module level)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", os.path.join(REPO, "bin", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seqs(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab - 2, rng.integers(1, 9)).tolist()
            for _ in range(n)]


def test_make_batches_match_reference():
    seqs = _seqs(11, LM_VOCAB, 0)
    ref = _reference_train_lm()
    want = ref.make_batches(seqs, 4, 8, 10, 11, -1,
                            np.random.default_rng(5))
    got = make_batches(seqs, 4, 8, 10, 11, rng=np.random.default_rng(5))
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_lm_train_steps_match_jax(smoothing):
    """Two steps from the same params (dropout 0): each step's loss and
    raw grad norm within rtol 1e-4, so the update between them (clip,
    Adam, Noam) agrees too."""
    jlm, v, lm = lm_pair(LM_VOCAB)
    ys_in, tgt = make_batches(_seqs(6, LM_VOCAB, 1), 6, 8, 10, 11)[0]
    tx = make_optimizer(32, 2, 1.0, 0.5)         # clip 0.5: clipping acts
    params, opt_state = v["params"], None
    opt_state = tx.init(params)

    def loss_fn(p):
        return jax_ls_loss(jlm.apply({"params": p}, jnp.asarray(ys_in)),
                           jnp.asarray(tgt), smoothing)[0]

    want = []
    loss_and_grads, update = jax.jit(jax.value_and_grad(loss_fn)), \
        jax.jit(tx.update)
    for _ in range(2):
        loss, grads = loss_and_grads(params)
        want.append((float(loss), float(optax.global_norm(grads))))
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    step = LMTrainStep(lm, NoamAdam(lm.parameters(), 32, 2, 1.0, 0.5),
                       smoothing, device="cpu")
    got = [(float(m["loss"]), float(m["grad_norm"]))
           for m in (step(ys_in, tgt) for _ in range(2))]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert want[0][1] > 0.5 and step.steps == 2


def _write_set(tmp_path):
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    write_synthetic_manifest(str(tmp_path / "all.jsonl"), 16, 64, seed=0)
    lines = open(tmp_path / "all.jsonl").read().splitlines()
    (tmp_path / "cv.jsonl").write_text("\n".join(lines[:5]) + "\n")
    (tmp_path / "train.jsonl").write_text("\n".join(lines[5:]) + "\n")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A hybrid_dev checkpoint and a small LM, trained on the CPU on 11
    synthetic utterances (5 held out)."""
    from tpu_asr_torch.train.__main__ import main as train
    from tpu_asr_torch.train_lm import main as train_lm
    d = tmp_path_factory.mktemp("cli")
    _write_set(d)
    data = ["--train-manifest", str(d / "train.jsonl"), "--cv-manifest",
            str(d / "cv.jsonl"), "--vocab-size", "64", "--device", "cpu"]
    train(["--preset", "hybrid_dev", "--epochs", "2", "--save-folder",
           str(d / "exp")] + data)
    train_lm(["--d-model", "32", "--d-inner", "64", "--num-heads", "2",
              "--num-layers", "2", "--epochs", "3", "--batch-size", "4",
              "--save-folder", str(d / "lm")] + data)
    return d


def test_train_lm_writes_its_folder(trained):
    from tpu_asr_torch.models.lm import load_lm, load_lm_config
    from tpu_asr_torch.train.checkpoints import Checkpointer
    lm_dir = str(trained / "lm")
    cfg = load_lm_config(lm_dir)
    assert (cfg.vocab_size, cfg.d_model, cfg.num_layers) == (64, 32, 2)
    lines = [json.loads(x) for x in open(trained / "lm" / "metrics.jsonl")]
    assert [x["epoch"] for x in lines] == [0, 1, 2]
    assert {"step", "phase", "loss", "ppl", "train_loss", "train_ppl",
            "epoch_sec"} <= set(lines[0])
    assert all(np.isfinite(x["loss"]) for x in lines)
    best = json.load(open(trained / "lm" / "best.json"))
    best_line = min(lines, key=lambda x: x["loss"])   # rounded to 1e-6
    assert best["step"] == best_line["step"]
    assert abs(best["cv_loss"] - best_line["loss"]) <= 1e-6
    lm = load_lm(lm_dir)
    state = Checkpointer(lm_dir).restore(best["step"])["model"]
    assert all(torch.equal(lm.state_dict()[k], state[k]) for k in state)


def test_train_lm_resumes(trained, tmp_path):
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.train_lm import main as train_lm
    lm_dir = trained / "lm"
    train_lm(["--train-manifest", str(trained / "train.jsonl"),
              "--cv-manifest", str(trained / "cv.jsonl"), "--vocab-size",
              "64", "--d-model", "32", "--d-inner", "64", "--num-heads",
              "2", "--num-layers", "2", "--epochs", "4", "--batch-size",
              "4", "--device", "cpu", "--save-folder", str(tmp_path),
              "--continue-from", str(lm_dir)])
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    last = Checkpointer(str(lm_dir)).latest_step()
    assert [x["epoch"] for x in lines] == [3]
    assert lines[0]["step"] == last + last // 3


@pytest.mark.parametrize("mode", ["joint", "ctc_beam", "attn_rescore"])
def test_recognize_with_lm_then_score(trained, mode, capsys):
    from tpu_asr_torch.recognize import main as recognize
    from tpu_asr_torch.score import main as score
    hyp = trained / f"hyp_{mode}.jsonl"
    summary = recognize([
        "--ckpt", str(trained / "exp"), "--manifest",
        str(trained / "cv.jsonl"), "--mode", mode, "--beam", "3",
        "--max-len", "12", "--nbest", "2", "--lm-ckpt",
        str(trained / "lm"), "--lm-weight", "0.3", "--output", str(hyp),
        "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == summary
    assert summary["n_utts"] == 5 and summary["mode"] == mode
    assert {"inverse_rtf", "wall_s", "cer"} <= set(summary)
    lines = [json.loads(x) for x in open(hyp)]
    assert sorted(x["id"] for x in lines) == [f"synth{i:06d}"
                                              for i in range(5)]
    assert all(len(x["nbest"]) == 2 and x["nbest"][0]["yseq"] ==
               x["hyp_tokens"] for x in lines)
    scored = score(["--manifest", str(trained / "cv.jsonl"), "--hyp",
                    str(hyp)])
    assert scored["cer"] == summary["cer"]
    assert scored["n_utts"] == 5 and scored["missing_refs"] == 0
    assert scored["sub"] + scored["ins"] + scored["del"] == round(
        scored["cer"] * scored["ref_tokens"])
    assert len(scored["worst"]) == 5


def test_recognize_greedy_writes_times(trained):
    from tpu_asr_torch.recognize import main as recognize
    hyp = trained / "hyp_greedy.jsonl"
    summary = recognize(["--ckpt", str(trained / "exp"), "--manifest",
                         str(trained / "cv.jsonl"), "--mode", "greedy_ctc",
                         "--restore", "latest", "--output", str(hyp),
                         "--device", "cpu"])
    assert summary["mode"] == "greedy_ctc"
    for x in map(json.loads, open(hyp)):
        assert len(x["times"]) == len(x["confidence"]) == \
            len(x["hyp_tokens"])


def test_serve_with_dict_and_lm(trained, tmp_path):
    """--dict fills "text"; --lm-ckpt fuses the LM; --restore latest."""
    from tpu_asr_torch.serve import (build_server, load_char_list,
                                     make_http_server, parse_args)
    from tpu_asr_torch.utils.vocab import Vocab
    Vocab([f"t{i}" for i in range(64)]).save(str(tmp_path / "dict.txt"))
    args = parse_args(["--ckpt", str(trained / "exp"), "--device", "cpu",
                       "--mode", "joint", "--beam", "3", "--max-len", "12",
                       "--bucket-frames", "256", "--batch-size", "2",
                       "--restore", "latest", "--lm-ckpt",
                       str(trained / "lm"), "--lm-weight", "0.3",
                       "--dict", str(tmp_path / "dict.txt")])
    server = build_server(args)
    assert server.rec.lm is not None and server.rec.beam.lm_weight == 0.3
    server.start()
    httpd = make_http_server("127.0.0.1", 0, server, load_char_list(args))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        wav = np.load(json.loads(open(trained / "cv.jsonl").readline())
                      ["wav"])
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/recognize",
            data=json.dumps({"wav": wav.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert body["text"] == "".join(f"t{i}" for i in body["tokens"])
    assert body["text"] is not None


def test_trainer_flags():
    from tpu_asr_torch.train.__main__ import configure, parse_args
    from tpu_asr_torch.utils.vocab import Vocab
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        Vocab.build("abcdefg").save(os.path.join(d, "dict.txt"))
        args = parse_args(["--preset", "aishell", "--save-folder", d,
                           "--dict", os.path.join(d, "dict.txt"),
                           "--dtype", "f32", "--specaug-warp", "5",
                           "--print-freq", "7"])
        tc, mc = configure(args)
    assert mc.vocab_size == 11 and mc.dtype == torch.float32
    assert tc.specaug.time_warp_window == 5 and tc.print_freq == 7
    args = parse_args(["--preset", "hybrid_dev", "--save-folder", "x",
                       "--dtype", "bf16", "--vocab-size", "40",
                       "--dict", "unread.txt"])
    tc, mc = configure(args)
    assert mc.vocab_size == 40 and mc.dtype == torch.bfloat16
    assert tc.specaug is None and tc.print_freq == 50


def test_debug_nans_raises_before_the_update():
    from tpu_asr_torch.models.transformer import Transformer
    from tpu_asr_torch.train import TrainStep
    from torch_port_util import torch_cfg
    cfg = torch_cfg()
    model = Transformer(cfg)
    step = TrainStep(model, NoamAdam(model.parameters(), cfg.d_model),
                     device="cpu", debug_nans=True)
    feats = np.full((2, 120, 80), np.nan, np.float32)
    batch = {"feats": feats, "feat_lengths": np.array([120, 100]),
             "targets": np.array([[3, 4, 5], [6, 7, -1]]),
             "target_lengths": np.array([3, 2])}
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(FloatingPointError):
        step(batch)
    assert step.optimizer.count == 0
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    step.debug_nans = False
    step(batch)                                   # no check: it steps
    assert step.optimizer.count == 1


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    from tpu_asr_torch.train import loop
    from tpu_asr_torch.train.__main__ import build_solver, parse_args
    monkeypatch.setattr(loop, "PROFILE_STEPS", (1, 2))
    solver = build_solver(parse_args([
        "--preset", "hybrid_dev", "--synthetic", "12", "--epochs", "1",
        "--save-folder", str(tmp_path / "exp"), "--device", "cpu",
        "--profile-dir", str(tmp_path / "prof")]))
    solver.train()
    solver.metrics_writer.close()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


@pytest.mark.parametrize("module,args", [
    ("tpu_asr_torch.train_lm", ["--synthetic", "8"]),
    ("tpu_asr_torch.recognize", ["--ckpt", "{d}", "--manifest", "{d}/m"]),
])
def test_clis_refuse_cpu_without_asking(module, args, tmp_path):
    args = [a.format(d=tmp_path) for a in args]
    if module.endswith("train_lm"):
        args += ["--save-folder", str(tmp_path / "out")]
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy, torch; torch.cuda.is_available = lambda: False"
         f"\nsys.argv = ['x'] + {args!r}\n"
         f"runpy.run_module({module!r}, run_name='__main__')"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "out").exists()

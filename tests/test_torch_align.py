"""CTC forced alignment (tpu_asr_torch.ops.ctc.ctc_viterbi_align and
python -m tpu_asr_torch.align) and checkpoint averaging (python -m
tpu_asr_torch.average_checkpoints) on the CPU: the spans equal
tpu_asr's (random inputs, and inputs with exact ties, where the first of
stay, prev, skip wins) and a brute-force best path's; the CLI writes the
reference's fields for both input layers; an averaged checkpoint holds
the float32 mean of its steps and decodes."""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.ops.ctc import ctc_viterbi_align as jax_align
from tpu_asr_torch.ops.ctc import ctc_viterbi_align

_spec = importlib.util.spec_from_file_location(
    "ref_test_align", os.path.join(os.path.dirname(__file__), "unit",
                                   "test_align.py"))
ref_test_align = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_test_align)


def _case(seed, b=5, t=23, v=7, u=6, quantize=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, v)) * 2
    if quantize:                 # log-probs on a grid of 0.5: exact ties
        x = np.round(x) / 2
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    labels[1, 2] = labels[1, 1]              # a repeat needs a blank gap
    t_lens = np.array([t, t - 3, 3, 0, 11][:b], np.int32)
    u_lens = np.array([u, u - 2, 3, 2, 0][:b], np.int32)
    return x.astype(np.float32), labels, t_lens, u_lens


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_spans_equal_reference(seed, ties):
    """Rows with no frames or no labels give -1 spans."""
    x, labels, tl, ul = _case(seed, quantize=ties)
    want = jax_align(jnp.asarray(x), jnp.asarray(labels), jnp.asarray(tl),
                     jnp.asarray(ul), log_input=ties)
    got = ctc_viterbi_align(torch.from_numpy(x), torch.from_numpy(labels),
                            torch.from_numpy(tl), torch.from_numpy(ul),
                            log_input=ties)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][3:] == -1).all()


def test_spans_equal_brute_force_best_path():
    rng = np.random.default_rng(0)
    b, t, u, v = 4, 6, 2, 5
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 2
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    tl = np.array([6, 5, 4, 6], np.int32)
    ul = np.array([2, 2, 1, 2], np.int32)
    starts, ends = (x.numpy() for x in ctc_viterbi_align(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(tl), torch.from_numpy(ul)))
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for i in range(b):
        ws, we = ref_test_align.brute_force_best_spans(
            logp[i], list(labels[i]), int(tl[i]), int(ul[i]))
        assert list(starts[i, :ul[i]]) == ws
        assert list(ends[i, :ul[i]]) == we


def test_spans_wellformed_and_pad_invariant():
    x, labels, tl, ul = _case(5, b=3, t=40, v=12)
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(a) for a in (x, labels, tl, ul)]
    starts, ends = (a.numpy() for a in ctc_viterbi_align(*args))
    for i in range(3):
        st, en = starts[i, :ul[i]], ends[i, :ul[i]]
        assert np.all(st >= 0) and np.all(en >= st) and np.all(en < tl[i])
        assert np.all(st[1:] > en[:-1])
    wide = [torch.cat([args[0], torch.from_numpy(rng.standard_normal(
        (3, 8, 12)).astype(np.float32))], dim=1),
        torch.cat([args[1], torch.from_numpy(rng.integers(
            1, 12, (3, 2)).astype(np.int32))], dim=1)] + args[2:]
    s2, e2 = ctc_viterbi_align(*wide)
    np.testing.assert_array_equal(s2.numpy()[:, :6], starts)
    np.testing.assert_array_equal(e2.numpy()[:, :6], ends)


def _checkpoint(folder, **model_kw):
    """A hybrid_dev-width checkpoint (vocab 16, seeded random weights) with
    `model_kw` changed -> its ModelConfig."""
    from tpu_asr_torch.configs.presets import get_preset
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.weights import init_random
    cfg = dataclasses.replace(get_preset("hybrid_dev").model, vocab_size=16,
                              **model_kw)
    ck = Checkpointer(folder)
    ck.save_config(cfg)
    ck.save_frontend(FrontendConfig())
    ck.save({"model": init_random(build_model(cfg), 0).state_dict()},
            step=1, is_best=True)
    return cfg


@pytest.mark.parametrize("input_layer,frame_s", [("conv2d", 0.04),
                                                 ("linear", 0.03)])
def test_align_cli_fields_and_seconds(tmp_path, input_layer, frame_s):
    """The JSONL has the reference's fields; an encoder frame is 4 input
    frames (conv2d) or lfr_n = 3 (linear); end_s ends the last frame;
    the spans are ctc_viterbi_align's on the model's CTC logits."""
    from tpu_asr_torch import align
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.frontend import wav_to_features
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.train.loop import apply_lfr, model_lfr
    exp = str(tmp_path / "exp")
    cfg = _checkpoint(exp, input_layer=input_layer)
    manifest = str(tmp_path / "m.jsonl")
    utts = write_synthetic_manifest(manifest, 3, 16)
    out = str(tmp_path / "align.jsonl")
    summary = align.main(["--ckpt", exp, "--manifest", manifest,
                          "--output", out, "--device", "cpu"])
    assert summary == {"n_utts": 3, "output": out, "frame_s": frame_s}
    with open(out) as f:
        lines = [json.loads(x) for x in f]
    model = build_model(cfg).eval()
    model.load_state_dict(Checkpointer(exp).restore()["model"])
    for line in lines:
        u = next(x for x in utts if x.id == line["id"])
        assert list(line) == ["id", "tokens", "start_frames", "end_frames",
                              "start_s", "end_s"]
        assert line["tokens"] == u.tokens
        wav = np.load(u.wav)[None]
        with torch.no_grad():
            f, fl = apply_lfr(*wav_to_features(
                torch.from_numpy(wav), torch.tensor([wav.shape[1]])),
                model_lfr(cfg))
            enc, el = model.encode(f, fl)
            st, en = ctc_viterbi_align(
                model.ctc_logits(enc), torch.tensor([u.tokens]), el,
                torch.tensor([len(u.tokens)]))
        assert line["start_frames"] == st[0].tolist()
        assert line["end_frames"] == en[0].tolist()
        assert line["start_s"] == [round(s * frame_s, 3)
                                   for s in line["start_frames"]]
        assert line["end_s"] == [round((e + 1) * frame_s, 3)
                                 for e in line["end_frames"]]


def test_align_needs_a_ctc_head(tmp_path):
    from tpu_asr_torch import align
    exp = str(tmp_path / "exp")
    _checkpoint(exp, model_type="transformer")
    with pytest.raises(SystemExit, match="CTC head"):
        align.main(["--ckpt", exp, "--manifest", "unused.jsonl",
                    "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A --pitch hybrid_dev checkpoint folder (d_input 83, the pitch
    frontend) holding three steps of different seeded weights, as three
    epochs would leave it -> (folder, manifest)."""
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.weights import init_random
    d = tmp_path_factory.mktemp("avg")
    manifest = str(d / "all.jsonl")
    write_synthetic_manifest(manifest, 4, 16)
    exp = str(d / "exp")
    cfg = _checkpoint(exp, d_input=83)
    ck = Checkpointer(exp)
    ck.save_frontend(FrontendConfig(add_pitch=True))
    model = build_model(cfg)
    for step in (4, 8, 12):
        ck.save({"model": init_random(model, step).state_dict(),
                 "step": step}, step=step, epoch=step // 4 - 1,
                cv_loss=1.0 / step, is_best=True)
    return exp, manifest


def test_train_pitch_builds_d_input_83(trained, tmp_path):
    """train --pitch on a wav manifest: the model's input width comes
    from the frontend (83); model_config.json and frontend.json record
    it (the solver is built, not run)."""
    from tpu_asr_torch.train.__main__ import build_solver, parse_args
    from tpu_asr_torch.train.checkpoints import Checkpointer
    exp = str(tmp_path / "exp")
    solver = build_solver(parse_args([
        "--preset", "hybrid_dev", "--train-manifest", trained[1],
        "--cv-manifest", trained[1], "--vocab-size", "16", "--pitch",
        "--save-folder", exp, "--device", "cpu"]))
    model = solver.train_step.model
    assert model.cfg.d_input == 83 and solver.train_step.lfr == (1, 1)
    ck = Checkpointer(exp)
    assert ck.load_config().d_input == 83
    assert ck.load_frontend().add_pitch and \
        ck.load_frontend().feature_dim == 83
    c2 = model.cfg.conv_channels
    c2 = c2[1] if isinstance(c2, tuple) else c2
    # the conv2d front end: 83 inputs leave 20 frequencies (80 leave 19)
    assert model.encoder.subsample.out.weight.shape[1] == 20 * c2


def test_average_checkpoints_float32_mean(trained, tmp_path):
    from tpu_asr_torch import average_checkpoints, recognize
    from tpu_asr_torch.train.checkpoints import Checkpointer
    exp, manifest = trained
    src = Checkpointer(exp)
    steps = src.all_steps()[-3:]
    assert steps == [4, 8, 12]
    out = str(tmp_path / "avg")
    assert average_checkpoints.main(["--ckpt", exp, "--out", out,
                                     "--last", "3", "--device", "cpu"]) \
        == steps
    states = [src.restore(s) for s in steps]
    got = Checkpointer(out).restore()
    for k, v in got["model"].items():
        if v.is_floating_point():
            want = (sum(s["model"][k].float() for s in states) / 3.0).to(
                v.dtype)
            assert torch.equal(v, want), k
        else:
            assert torch.equal(v, states[-1]["model"][k]), k
    assert got["step"] == states[-1]["step"] == 12
    assert got["meta"] == {**states[-1]["meta"], "averaged_steps": steps,
                           "is_best": True}
    with open(os.path.join(out, "best.json")) as f:
        assert json.load(f) == {"step": steps[-1], "averaged_steps": steps}
    assert Checkpointer(out).best_step() == steps[-1]
    summary = recognize.main(["--ckpt", out, "--manifest", manifest,
                              "--mode", "greedy_ctc", "--device", "cpu",
                              "--output", str(tmp_path / "h.jsonl")])
    assert summary["n_utts"] == 4


def test_average_keeps_the_frontend(trained, tmp_path):
    """The one deliberate difference from bin/average_checkpoints.py:
    frontend.json is copied. Without it (the reference's output), the
    --pitch checkpoint's 83-wide input layer meets the default 80-dim
    frontend and decoding fails."""
    from tpu_asr_torch import average_checkpoints, recognize
    from tpu_asr_torch.train.checkpoints import Checkpointer
    exp, manifest = trained
    out = str(tmp_path / "avg")
    average_checkpoints.main(["--ckpt", exp, "--out", out, "--device",
                              "cpu", "--steps", ",".join(map(
                                  str, Checkpointer(exp).all_steps()[:2]))])
    assert Checkpointer(out).load_frontend().add_pitch
    os.remove(os.path.join(out, "frontend.json"))
    with pytest.raises(RuntimeError):
        recognize.main(["--ckpt", out, "--manifest", manifest, "--mode",
                        "greedy_ctc", "--device", "cpu", "--output",
                        str(tmp_path / "h.jsonl")])


def test_average_refuses_missing_steps(trained, tmp_path):
    from tpu_asr_torch import average_checkpoints
    exp, _ = trained
    with pytest.raises(SystemExit, match="not in"):
        average_checkpoints.main(["--ckpt", exp, "--out",
                                  str(tmp_path / "x"), "--steps", "1,999",
                                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoints"):
        average_checkpoints.main(["--ckpt", str(tmp_path / "empty"),
                                  "--out", str(tmp_path / "y"),
                                  "--device", "cpu"])

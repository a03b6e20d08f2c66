"""Kaldi ark input (tpu_asr_torch.data.kaldi_io, the loader's, the
trainer's, compute_cmvn's and stream_demo's ark features) vs
tpu_asr.data.kaldi_io on the CPU: records written by either package
read bitwise in the other; an ark manifest (an espnet data.json) batches
as the same features in .npy do."""

import io
import json
import struct

import numpy as np
import pytest

from tpu_asr.data import kaldi_io as jkio
from tpu_asr_torch.data import kaldi_io as tkio


def _mats(seed=0, d=83):
    rng = np.random.default_rng(seed)
    return {f"utt{i}": rng.standard_normal((n, d)).astype(np.float32)
            for i, n in enumerate((37, 5, 120, 1))}


def _write_ark(path, mats, writer):
    """All of mats in one .ark -> {key: "path:offset"}."""
    with open(path, "wb") as f:
        return {k: f"{path}:{writer(f, m, key=k)}" for k, m in mats.items()}


@pytest.mark.parametrize("writer,reader", [
    (jkio.write_mat, tkio.read_mat), (tkio.write_mat, jkio.read_mat),
    (tkio.write_mat, tkio.read_mat)])
def test_ark_records_read_bitwise_both_ways(tmp_path, writer, reader):
    mats = _mats()
    specs = _write_ark(str(tmp_path / "feats.ark"), mats, writer)
    for k, spec in specs.items():
        got = reader(spec)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, mats[k])
    scp = tmp_path / "feats.scp"
    scp.write_text("".join(f"{k} {v}\n" for k, v in specs.items()))
    assert [k for k, _ in tkio.read_ark_scp(str(scp))] == list(mats)
    assert all(np.array_equal(m, mats[k])
               for k, m in tkio.read_ark_scp(str(scp)))


def test_double_matrices_and_refusals(tmp_path):
    """DM reads as float64; compressed (CM) and text records raise
    ValueError in both packages."""
    m = np.random.default_rng(1).standard_normal((4, 3))
    rec = (b"\x00BDM \x04" + struct.pack("<i", 4) + b"\x04"
           + struct.pack("<i", 3) + m.astype("<f8").tobytes())
    path = tmp_path / "d.ark"
    path.write_bytes(b"key " + rec)
    for reader in (tkio.read_mat, jkio.read_mat):
        got = reader(f"{path}:4")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, m)
    for body in (b"\x00BCM \x04\x00\x00\x00\x00", b" [ 1 2 ]\n"):
        path.write_bytes(body)
        for reader in (tkio.read_mat, jkio.read_mat):
            with pytest.raises(ValueError):
                reader(str(path))
    buf = io.BytesIO()
    assert tkio.write_mat(buf, np.zeros((2, 2)), key="a") == 2


def _espnet_dump(tmp_path, mats, tokens):
    """An espnet data.json whose "feat" entries point into one .ark,
    turned into a manifest by prepare_data --espnet-json, and the same
    features as .npy in a manifest -> (ark manifest, npy manifest)."""
    from tpu_asr_torch import prepare_data
    from tpu_asr_torch.data import Utterance, save_manifest
    specs = _write_ark(str(tmp_path / "feats.ark"), mats, tkio.write_mat)
    utts = {k: {"input": [{"feat": spec, "name": "input1",
                           "shape": list(mats[k].shape)}],
                "output": [{"name": "target1", "shape": [3, 16],
                            "tokenid": " ".join(map(str, tokens[k]))}]}
            for k, spec in specs.items()}
    js = tmp_path / "data.json"
    js.write_text(json.dumps({"utts": utts}))
    npy = []
    for k, m in mats.items():
        p = str(tmp_path / f"{k}.npy")
        np.save(p, m)
        npy.append(Utterance(id=k, tokens=tokens[k], feat=p,
                             num_frames=len(m)))
    save_manifest(npy, str(tmp_path / "npy.jsonl"))
    ark = str(tmp_path / "ark.jsonl")
    prepare_data.main(["--espnet-json", str(js), "--out", ark])
    return ark, str(tmp_path / "npy.jsonl")


def test_loader_batches_an_ark_manifest_as_npy(tmp_path):
    from tpu_asr_torch.data import DataLoader, load_manifest, make_buckets
    mats = _mats()
    tokens = {k: [2 + i, 3, 4][: 1 + i % 3] for i, k in enumerate(mats)}
    js, npy = _espnet_dump(tmp_path, mats, tokens)
    batches = {}
    for name, utts in (("ark", load_manifest(js)),
                       ("npy", load_manifest(npy))):
        assert all((".ark:" if name == "ark" else ".npy") in u.feat
                   for u in utts)
        buckets = make_buckets(utts, num_buckets=2, batch_frames=200,
                               max_frames_cap=300, length_key="num_frames")
        batches[name] = list(DataLoader(utts, buckets, mode="feat",
                                        shuffle=False))
    assert len(batches["ark"]) == len(batches["npy"]) > 1
    for a, b in zip(batches["ark"], batches["npy"]):
        assert a["ids"] == b["ids"]
        for k in ("feats", "feat_lengths", "targets", "target_lengths"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["feats"].dtype == np.float32 and a["feats"].shape[2] == 83


def test_compute_cmvn_on_ark_equals_npy(tmp_path):
    from tpu_asr_torch import compute_cmvn
    mats = _mats(2, d=80)
    js, npy = _espnet_dump(tmp_path, mats, {k: [3] for k in mats})
    out = {name: compute_cmvn.main(["--manifest", m, "--out",
                                    str(tmp_path / f"{name}.npz"),
                                    "--device", "cpu"])
           for name, m in (("ark", js), ("npy", npy))}
    for k in ("mean", "istd", "frames"):
        np.testing.assert_array_equal(out["ark"][k], out["npy"][k])
    allf = np.concatenate(list(mats.values())).astype(np.float64)
    np.testing.assert_allclose(out["ark"]["mean"], allf.mean(0), rtol=1e-6)


def test_trainer_on_83_dim_ark_features(tmp_path):
    """The trainer in feature mode reads the model's input width from
    the first utterance (83, an espnet AISHELL dump's fbank+pitch),
    records it, and steps; stream_demo reads the ark."""
    from tpu_asr_torch import stream_demo
    from tpu_asr_torch.train.__main__ import main as train_main
    from tpu_asr_torch.train.checkpoints import Checkpointer
    rng = np.random.default_rng(4)
    mats = {f"u{i}": rng.standard_normal((int(n), 83)).astype(np.float32)
            for i, n in enumerate(rng.integers(60, 140, 6))}
    js, _ = _espnet_dump(tmp_path, mats, {k: [2 + i % 5, 7] for i, k in
                                          enumerate(mats)})
    exp = str(tmp_path / "exp")
    train_main(["--preset", "hybrid_dev", "--train-manifest", js,
                "--cv-manifest", js, "--vocab-size", "16", "--epochs", "1",
                "--enc-chunk-size", "4", "--save-folder", exp,
                "--device", "cpu"])
    cfg = Checkpointer(exp).load_config()
    assert cfg.d_input == 83
    summary = stream_demo.main(["--ckpt", exp, "--manifest", js, "--quiet",
                                "--limit", "2", "--device", "cpu"])
    assert summary["n_utts"] == 2

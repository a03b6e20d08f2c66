"""The original PyTorch repo's `.pth.tar` into and out of the port
(tpu_asr_torch.parity, export_torch, recognize --torch-ckpt) against
tpu_asr.parity on the CPU, at hybrid_dev widths.

Reference-named state_dicts are built as tests/parity/test_torch_import.py
builds them: the JAX package's torch twin filled from flax params, its
keys renamed to the kaituoxu/eastonYi-lineage names. Logits: float32 on
both sides, atol 1e-5; weights and n-bests bit for bit.
"""

import dataclasses
import functools
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.parity.torch_import import \
    load_torch_checkpoint as jax_load_torch_checkpoint
from tpu_asr_torch.parity import torch_export, torch_import
from tpu_asr_torch.weights import torch_to_flax
from torch_port_util import (VOCAB, cif_torch_model, flat_flax_params,
                             flax_params, jax_cfg, torch_cfg, torch_model)

ATOL = 1e-5

# twin-style -> reference-style key renames (the inverse of KEY_ALIASES,
# applied in inverse order), as tests/parity/test_torch_import.py has them
TWIN_TO_REFERENCE = [
    (r"^enc_layers\.(\d+)\.norm_attn\.", r"enc_layers.\1.slf_attn.layer_norm."),
    (r"^dec_layers\.(\d+)\.norm_slf\.", r"dec_layers.\1.slf_attn.layer_norm."),
    (r"^dec_layers\.(\d+)\.norm_crs\.", r"dec_layers.\1.crs_attn.layer_norm."),
    (r"\.norm_ffn\.", ".ffn.layer_norm."),
    (r"(_attn\.)out_proj\.", r"\1fc."),
    (r"\.q_proj\.", ".w_qs."),
    (r"\.k_proj\.", ".w_ks."),
    (r"\.v_proj\.", ".w_vs."),
    (r"\.crs_attn\.", ".enc_attn."),
    (r"\.ffn\.", ".pos_ffn."),
    (r"^enc_layers\.(\d+)\.", r"encoder.layer_stack.\1."),
    (r"^dec_layers\.(\d+)\.", r"decoder.layer_stack.\1."),
    (r"^embed\.", "decoder.tgt_word_emb."),
    (r"^subsample\.conv([12])\.", r"encoder.conv.conv_\1."),
    (r"^subsample\.out\.", "encoder.conv.out."),
    (r"^ctc_proj\.", "ctc.ctc_lo."),
]


def reference_state_dict(params, cfg=None) -> dict:
    """flax params -> the reference-named state_dict, through the JAX
    package's twin."""
    from tpu_asr.parity.torch_twin import TorchTransformer, import_flax_params
    twin = TorchTransformer(cfg or jax_cfg())
    import_flax_params(twin, params)
    out = {}
    for k, v in twin.state_dict().items():
        for pat, repl in TWIN_TO_REFERENCE:
            k = re.sub(pat, repl, k)
        out[k] = v
    return out


def save_blob(path, sd, **hyp):
    torch.save({"state_dict": sd, "epoch": 7, "tr_loss": [1.0],
                "cv_loss": [2.0], "optim_dict": {}, "n_head": 2,
                "dropout": 0.1, "pe_maxlen": 5000, **hyp}, str(path))
    return str(path)


@functools.lru_cache(maxsize=1)
def inputs():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 45, 80)).astype(np.float32)
    flens = np.asarray([45, 30], np.int32)
    ys = rng.integers(2, VOCAB - 2, (2, 5)).astype(np.int32)
    return feats, flens, ys


def jax_logits(cfg, params) -> dict:
    feats, flens, ys = inputs()
    m = JaxTransformer(cfg)

    @jax.jit
    def run(p):
        enc, el = m.apply(p, feats, flens, method="encode")
        out = {}
        if cfg.model_type in ("ctc", "hybrid"):
            out["ctc"] = m.apply(p, enc, method="ctc_logits")
        if cfg.num_dec_layers > 0:
            out["dec"] = m.apply(p, enc, el, ys, method="decode_logits")
        return out
    return {k: np.asarray(v) for k, v in run(params).items()}


def port_logits(model, cfg) -> dict:
    feats, flens, ys = inputs()
    model.eval()
    out = {}
    with torch.no_grad():
        enc, el = model.encode(torch.from_numpy(feats),
                               torch.from_numpy(flens))
        if cfg.model_type in ("ctc", "hybrid"):
            out["ctc"] = model.ctc_logits(enc).numpy()
        if cfg.num_dec_layers > 0:
            out["dec"] = model.decode_logits(
                enc, el, torch.from_numpy(ys).long()).numpy()
    return out


def assert_logits_equal(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=k)


def assert_same_config(port_cfg, jax_cfg_):
    a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg_)
    for k in ("dtype", "param_dtype"):
        assert str(a.pop(k)).rsplit(".", 1)[-1] == np.dtype(b.pop(k)).name
    assert a == b


# the fields a serialize blob and its tensors pin down
STRUCTURE = ("model_type", "vocab_size", "d_model", "d_inner", "num_heads",
             "num_enc_layers", "num_dec_layers", "input_layer",
             "conv_channels", "tie_embedding")


def assert_same_structure(a, b):
    keys = [k for k in STRUCTURE if k != "conv_channels"
            or a.input_layer == "conv2d"]       # a linear input has none
    assert {k: getattr(a, k) for k in keys} == \
        {k: getattr(b, k) for k in keys}


def assert_same_tree(got: dict, want: dict):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[k]),
                                      np.asarray(flat_want[k]), str(k))


# ---- import ----

def test_reference_checkpoint_imports_as_the_jax_package_does(tmp_path):
    """A reference-named serialize blob with no config: the same config,
    the same flax tree bit for bit, and the same encoder, CTC and
    decoder logits."""
    path = save_blob(tmp_path / "final.pth.tar",
                     reference_state_dict(flax_params()), d_model=64)
    want_params, want_cfg = jax_load_torch_checkpoint(path)
    got_params, got_cfg = torch_import.load_torch_checkpoint(path)
    assert got_cfg.model_type == "hybrid" and got_cfg.conv_channels == (8, 16)
    assert_same_config(got_cfg, want_cfg)
    assert_same_tree(got_params, want_params)
    model, _ = torch_import.load_torch_model(path)
    assert_logits_equal(port_logits(model, got_cfg),
                        jax_logits(want_cfg, want_params))


@pytest.mark.parametrize("drop,model_type", [("ctc.", "transformer"),
                                             ("decoder.", "ctc")])
def test_attention_only_and_ctc_only_infer_their_type(tmp_path, drop,
                                                      model_type):
    sd = {k: v for k, v in reference_state_dict(flax_params()).items()
          if not k.startswith(drop)}
    path = save_blob(tmp_path / "part.pth.tar", sd)
    want_params, want_cfg = jax_load_torch_checkpoint(path)
    model, got_cfg = torch_import.load_torch_model(path)
    assert got_cfg.model_type == want_cfg.model_type == model_type
    assert_same_config(got_cfg, want_cfg)
    assert_logits_equal(port_logits(model, got_cfg),
                        jax_logits(want_cfg, want_params))


def test_untied_biasfree_projection_imports(tmp_path):
    """An untied reference checkpoint's bias-free tgt_word_prj becomes the
    decoder's out_proj."""
    cfg = jax_cfg(tie_embedding=False)
    params = jax.device_get(jax.jit(JaxTransformer(cfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32)))
    sd = reference_state_dict(params)         # the twin ties: add the head
    kern = np.asarray(params["params"]["decoder"]["out_proj"]["kernel"])
    sd["decoder.tgt_word_prj.weight"] = torch.tensor(kern.T.copy())
    path = save_blob(tmp_path / "untied.pth.tar", sd)
    want_params, want_cfg = jax_load_torch_checkpoint(path)
    model, got_cfg = torch_import.load_torch_model(path)
    assert not got_cfg.tie_embedding
    assert set(model.state_dict()) >= {"decoder.out_proj.weight"}
    assert "decoder.out_proj.bias" not in model.state_dict()
    assert_same_config(got_cfg, want_cfg)
    assert_logits_equal(port_logits(model, got_cfg),
                        jax_logits(want_cfg, want_params))


def test_dataparallel_prefix_is_dropped(tmp_path):
    sd = reference_state_dict(flax_params())
    plain = save_blob(tmp_path / "plain.pth.tar", sd)
    wrapped = save_blob(tmp_path / "wrapped.pth.tar",
                        {f"module.{k}": v for k, v in sd.items()})
    a, cfg_a = torch_import.load_torch_checkpoint(plain)
    b, cfg_b = torch_import.load_torch_checkpoint(wrapped)
    assert cfg_a == cfg_b
    assert_same_tree(b, a)


class _Payload:
    """An object whose unpickling would write a file."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (open, (self.marker, "w"))


def test_non_tensor_pickle_is_refused(tmp_path):
    marker = tmp_path / "unpickled"
    path = str(tmp_path / "bad.pth.tar")
    torch.save({"state_dict": reference_state_dict(flax_params()),
                "args": _Payload(str(marker))}, path)
    with pytest.raises(ValueError, match=re.escape(path)):
        torch_import.load_torch_checkpoint(path)
    assert not marker.exists()


# ---- export ----

def test_torch_to_flax_inverts_load_jax_params():
    want = flat_flax_params()
    got = torch_to_flax(torch_model())
    want = {k[len("params/"):]: v for k, v in want.items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], k)


def test_export_reads_back_in_the_jax_package(tmp_path):
    """The port's hybrid_dev model exported: tpu_asr.parity reads it and
    gives the port's logits."""
    from tpu_asr_torch.weights import init_random
    cfg = torch_cfg()
    model = init_random(torch_model(), 11)
    path = str(tmp_path / "export.pth.tar")
    torch_export.export_model(path, model, cfg, epoch=3, cv_loss=1.5)
    want_params, want_cfg = jax_load_torch_checkpoint(path)
    assert_same_structure(cfg, want_cfg)
    assert_logits_equal(port_logits(model, cfg),
                        jax_logits(want_cfg, want_params))


@pytest.mark.parametrize("case", ["hybrid", "transformer_linear_untied",
                                  "ctc"])
def test_export_then_import_restores_every_tensor(tmp_path, case):
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.weights import init_random
    cfg = {"hybrid": torch_cfg(),
           "transformer_linear_untied": torch_cfg(
               model_type="transformer", input_layer="linear",
               tie_embedding=False, num_enc_layers=1),
           "ctc": torch_cfg(model_type="ctc", num_dec_layers=0)}[case]
    model = init_random(build_model(cfg), 4)
    path = str(tmp_path / f"{case}.pth.tar")
    torch_export.export_model(path, model, cfg)
    back, back_cfg = torch_import.load_torch_model(path)
    assert_same_structure(back_cfg, cfg)
    want, got = model.state_dict(), back.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cif_and_conformer_refuse_to_export(tmp_path):
    from tpu_asr_torch.models import build_model
    from torch_port_util import conformer_torch_cfg, cif_torch_cfg
    with pytest.raises(ValueError, match="covers transformer/ctc/hybrid "
                                         r"\(got cif\)"):
        torch_export.export_model(str(tmp_path / "c.pth.tar"),
                                  cif_torch_model(), cif_torch_cfg())
    cfg = conformer_torch_cfg()
    with pytest.raises(ValueError, match="transformer encoder"):
        torch_export.export_model(str(tmp_path / "k.pth.tar"),
                                  build_model(cfg), cfg)
    assert not os.listdir(tmp_path)


# ---- the CLIs: export_torch and recognize --torch-ckpt ----

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A port checkpoint folder of the hybrid_dev model (two steps, the
    best one the first) and a wav manifest of 3 utterances."""
    from tpu_asr_torch.data.synthetic import write_synthetic_manifest
    from tpu_asr_torch.frontend import FrontendConfig
    from tpu_asr_torch.train.checkpoints import Checkpointer
    from tpu_asr_torch.weights import init_random
    root = tmp_path_factory.mktemp("torch_ckpt")
    cfg = torch_cfg()
    ck = Checkpointer(str(root / "exp"))
    ck.save_config(cfg)
    ck.save_frontend(FrontendConfig())
    models = {}
    for step, seed, best in ((10, 0, True), (20, 1, False)):
        models[step] = torch_model(seed)
        ck.save({"model": models[step].state_dict(), "step": step}, step,
                epoch=step // 10, cv_loss=1.0 + step, is_best=best)
    manifest = str(root / "cv.jsonl")
    write_synthetic_manifest(manifest, 3, VOCAB, seed=3, max_tokens=6)
    return {"root": root, "exp": str(root / "exp"), "manifest": manifest,
            "models": models}


def test_export_cli_writes_the_chosen_step(folder, tmp_path):
    from tpu_asr_torch import export_torch
    for restore, step in (("best", 10), ("latest", 20)):
        out = str(tmp_path / f"{restore}.pth.tar")
        assert export_torch.main(["--ckpt", folder["exp"], "--out", out,
                                  "--restore", restore]) == step
        back, _ = torch_import.load_torch_model(out)
        want = folder["models"][step].state_dict()
        for k, v in back.state_dict().items():
            assert torch.equal(v, want[k]), (restore, k)
        blob = torch.load(out, weights_only=True)
        assert blob["epoch"] == step // 10 and blob["model_type"] == "hybrid"


JOINT = ["--mode", "joint", "--beam", "5", "--nbest", "2", "--max-len", "8"]


def _decode(argv, out, mode=JOINT):
    from tpu_asr_torch import recognize
    summary = recognize.main(argv + mode + ["--output", out, "--device",
                                            "cpu"])
    with open(out) as f:
        return summary, [json.loads(x) for x in f]


def test_recognize_torch_ckpt_equals_ckpt(folder, tmp_path):
    """Joint beam 5 from the exported file with --ckpt's sidecars gives
    --ckpt's n-best, scores included, bit for bit; with the config
    inferred from the file alone, greedy CTC gives --ckpt's, and the
    output defaults to hyp.jsonl beside the file."""
    from tpu_asr_torch import export_torch, recognize
    pth = str(tmp_path / "best.pth.tar")
    export_torch.main(["--ckpt", folder["exp"], "--out", pth])
    base = ["--manifest", folder["manifest"]]
    want_sum, want = _decode(base + ["--ckpt", folder["exp"]],
                             str(tmp_path / "ckpt.jsonl"))
    got_sum, got = _decode(base + ["--torch-ckpt", pth, "--ckpt",
                                   folder["exp"]],
                           str(tmp_path / "torch.jsonl"))
    assert got == want
    assert len(want) == got_sum["n_utts"] == want_sum["n_utts"] == 3
    assert len(want[0]["nbest"]) == 2
    assert got_sum["cer"] == want_sum["cer"]
    greedy = ["--mode", "greedy_ctc"]
    _, want = _decode(base + ["--ckpt", folder["exp"]],
                      str(tmp_path / "ckpt_greedy.jsonl"), mode=greedy)
    recognize.main(base + ["--torch-ckpt", pth, "--device", "cpu"] + greedy)
    with open(tmp_path / "hyp.jsonl") as f:
        assert [json.loads(x) for x in f] == want


def test_recognize_needs_a_checkpoint(folder):
    from tpu_asr_torch import recognize
    with pytest.raises(SystemExit):
        recognize.parse_args(["--manifest", folder["manifest"]])


@pytest.mark.parametrize("cut", ["batch", "row"])
def test_recognize_raises_when_ids_and_nbests_differ(folder, tmp_path,
                                                     monkeypatch, cut):
    """A decode_batches_nbest that gives one batch, or one row, too few
    makes recognize raise, naming both counts."""
    from tpu_asr_torch.decode.recognizer import Recognizer
    real = Recognizer.decode_batches_nbest

    def short(self, batches, window=8):
        out = real(self, batches, window)
        if isinstance(batches, list):          # decode_batch_nbest's call
            return out
        return out[:-1] if cut == "batch" else [b[:-1] for b in out]
    monkeypatch.setattr(Recognizer, "decode_batches_nbest", short)
    match = ("batches of ids but" if cut == "batch"
             else r"ids in \d+ rows but \d+ n-bests")
    with pytest.raises(AssertionError, match=match):
        _decode(["--manifest", folder["manifest"], "--ckpt", folder["exp"]],
                str(tmp_path / "h.jsonl"), mode=["--mode", "greedy_ctc"])

"""The bridge from tpu_asr's orbax checkpoints into the port:
tools/orbax_to_npz.py (JAX side) then python -m tpu_asr_torch.import_params
(the port's side), on the CPU at dev widths.

tpu_asr's own Checkpointer saves a TrainState of known flax params, as
bin/train.py and bin/train_lm.py do; after the two tools, the folder the
port reads gives the JAX model's logits (float32, atol 1e-5) and holds
every weight bit for bit.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr.train import TrainState, make_optimizer
from tpu_asr.train.checkpoints import Checkpointer as JaxCheckpointer
from torch_port_util import (VOCAB, conformer_flax_params, conformer_jax_cfg,
                             flax_params, jax_cfg, lm_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5


def orbax_to_npz():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", os.path.join(REPO, "tools", "orbax_to_npz.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def save_jax(folder, params, d_model, step=7, accum_steps=1):
    """A TrainState of `params` saved by tpu_asr's Checkpointer as step
    `step` (the best), as the JAX trainers save."""
    state = TrainState.create(params["params"],
                              make_optimizer(d_model,
                                             accum_steps=accum_steps),
                              jax.random.PRNGKey(0))
    state = state.replace(step=step)
    ck = JaxCheckpointer(folder)
    ck.save(state, epoch=3, cv_loss=1.25, is_best=True)
    ck.wait()
    return ck


def bridge(src, tmp_path):
    """orbax folder -> npz folder -> port checkpoint folder."""
    from tpu_asr_torch import import_params
    npz = str(tmp_path / "npz")
    meta = orbax_to_npz().main(["--ckpt", src, "--out", npz])
    out = str(tmp_path / "port")
    assert import_params.main(["--src", npz, "--out", out,
                               "--device", "cpu"]) == meta["step"]
    return npz, out


def asr_logits(model, feats, flens, ys):
    model.eval()
    with torch.no_grad():
        enc, el = model.encode(torch.from_numpy(feats),
                               torch.from_numpy(flens))
        return (model.ctc_logits(enc).numpy(),
                model.decode_logits(enc, el, torch.from_numpy(ys).long())
                .numpy())


@pytest.mark.parametrize("family", ["hybrid_dev", "conformer_dev"])
def test_asr_checkpoint_through_the_bridge(tmp_path, family):
    from tpu_asr.frontend import FrontendConfig as JaxFrontend
    from tpu_asr.models import Transformer as JaxTransformer
    from tpu_asr_torch.models import build_model
    from tpu_asr_torch.recognize import restore_step
    from tpu_asr_torch.train.checkpoints import Checkpointer

    cfg, params = {"hybrid_dev": (jax_cfg, flax_params),
                   "conformer_dev": (conformer_jax_cfg,
                                     conformer_flax_params)}[family]
    cfg, params = cfg(), params()
    src = str(tmp_path / "jax")
    ck = save_jax(src, params, cfg.d_model,
                  accum_steps=2 if family == "conformer_dev" else 1)
    ck.save_config(cfg)
    ck.save_frontend(JaxFrontend(remove_dc=False))
    npz, out = bridge(src, tmp_path)
    assert json.load(open(os.path.join(npz, "meta.json")))["epoch"] == 3

    port = Checkpointer(out)
    port_cfg = port.load_config()
    assert port_cfg.encoder_type == cfg.encoder_type
    assert port.load_frontend().remove_dc is False
    step = restore_step(port, -1, "best")
    assert step == 7 and json.load(open(os.path.join(out, "best.json"))
                                   )["cv_loss"] == 1.25
    model = build_model(port_cfg)
    model.load_state_dict(port.restore(step)["model"])

    rng = np.random.default_rng(9)
    feats = rng.standard_normal((2, 45, 80)).astype(np.float32)
    flens = np.asarray([45, 33], np.int32)
    ys = rng.integers(2, VOCAB - 2, (2, 5)).astype(np.int32)
    jm = JaxTransformer(cfg)

    @jax.jit
    def run(p):
        enc, el = jm.apply(p, feats, flens, method="encode")
        return (jm.apply(p, enc, method="ctc_logits"),
                jm.apply(p, enc, el, ys, method="decode_logits"))
    for got, want, what in zip(asr_logits(model, feats, flens, ys),
                               run(params), ("ctc", "decoder")):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0,
                                   err_msg=what)


def test_lm_checkpoint_through_the_bridge(tmp_path):
    """A bin/train_lm.py folder (lm_config.json) -> a folder that
    --lm-ckpt (models.lm.load_lm) reads."""
    from tpu_asr.models.lm import save_lm_config
    from tpu_asr_torch.models.lm import load_lm
    jlm, variables, want_lm = lm_pair()
    src = str(tmp_path / "jax_lm")
    save_jax(src, variables, jlm.cfg.d_model, step=12)
    save_lm_config(src, jlm.cfg)
    _, out = bridge(src, tmp_path)
    lm = load_lm(out)
    want = want_lm.state_dict()
    for k, v in lm.state_dict().items():
        assert torch.equal(v, want[k]), k
    tokens = np.random.default_rng(4).integers(0, VOCAB, (2, 6))
    want_logits = jlm.apply(variables, jnp.asarray(tokens, jnp.int32))
    lm.eval()
    with torch.no_grad():
        got = lm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits),
                               atol=ATOL, rtol=0)


def test_import_params_refuses_a_folder_without_config(tmp_path):
    from tpu_asr_torch import import_params
    np.savez(tmp_path / "params.npz", x=np.zeros(1, np.float32))
    with pytest.raises(SystemExit):
        import_params.main(["--src", str(tmp_path), "--out",
                            str(tmp_path / "o"), "--device", "cpu"])

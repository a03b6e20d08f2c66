"""Data and tensor parallelism of the port (tpu_asr_torch.parallel) on the
CPU: a mesh is a change of layout, not of numbers.

- The mesh's rank coordinates, shard_batch's rows and the sharding rules
  equal tpu_asr.parallel's (make_mesh's reshape, the addressable shards
  on the 8 fake CPU devices, `_spec_for`), with no process started.
- One process group of four gloo ranks (tests/torch_parallel_ranks.py,
  started once for the module) runs every other case; each parametrised
  test reads its case's result. With dropout 0, a train step on a
  dp 2 x tp 2 mesh equals the port's single-process step for the
  hybrid (CTC through the plain kernel pair), CIF, transducer and
  conformer models: loss and grad norm within rtol 2e-4, every gradient
  within atol 1e-5 / rtol 1e-3 (tpu_asr's own bounds for its mesh step,
  tests/unit/test_train.py), on a batch whose shards hold uneven token
  counts and on one whose second shard is all dummy rows; so does a
  step with SpecAugment on, and the eval step's global losses.
  Recognizer(mesh=...) on a 4 x 1 mesh gives the single-process n-best
  (same yseq, scores within 1e-5) in five modes.
- Every family's step is also held against tpu_asr's make_train_step
  on make_mesh(4, 2) with shard_params (jitted, from the same flax
  params and batch): its metrics and its whole gradient tree, which an
  optimizer that keeps the gradients as its state hands back. Joint
  decode is held against tpu_asr's mesh Recognizer.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_asr import IGNORE_ID
from tpu_asr_torch.augment import SpecAugmentConfig
from tpu_asr_torch.parallel.mesh import Axis, Mesh, mesh_groups, shard_batch
from tpu_asr_torch.parallel.sharding import param_specs
from tpu_asr_torch.weights import flax_to_torch, load_jax_params
from torch_port_util import (VOCAB, cif_flax_params, cif_jax_cfg,
                             cif_torch_cfg, conformer_flax_params,
                             conformer_jax_cfg, conformer_torch_cfg,
                             flax_params, jax_cfg, torch_cfg,
                             transducer_flax_params, transducer_jax_cfg,
                             transducer_torch_cfg)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SPAWN_TIMEOUT_S = 300
LOSS_RTOL = 2e-4
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)


def make_batch(flens, tlens, seed=0, t=61, u=6):
    rng = np.random.default_rng(seed)
    b = len(flens)
    targets = np.full((b, u), IGNORE_ID, np.int32)
    for i, n in enumerate(tlens):
        targets[i, :n] = rng.integers(2, VOCAB - 2, n)
    return {"feats": rng.standard_normal((b, t, 80)).astype(np.float32),
            "feat_lengths": np.asarray(flens, np.int32),
            "targets": targets,
            "target_lengths": np.asarray(tlens, np.int32)}


# shard 0 holds rows 0-1 (13 tokens), shard 1 rows 2-3 (5 tokens)
UNEVEN = make_batch((61, 50, 41, 37), (6, 5, 2, 1))
# shard 1 is all dummy rows (feat_lengths 0, no targets)
DUMMY_SHARD = make_batch((61, 44, 0, 0), (5, 3, 0, 0), seed=1)
BATCHES = {"uneven": UNEVEN, "dummy_shard": DUMMY_SHARD}
DECODE_BATCH = {"feats": np.random.default_rng(7).standard_normal(
    (4, 64, 80)).astype(np.float32),
    "feat_lengths": np.asarray([64, 50, 41, 33], np.int32)}
SPECAUG = SpecAugmentConfig(freq_mask_width=8, time_mask_width=10)

def _drawn_biases(variables, seed):
    """A copy of flax variables with every bias leaf (the rel-pos u/v and
    the joint's included) drawn from N(0, 0.1), so that a bias read by
    the wrong heads shows."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.array(leaf)
        if str(path[-1].key).endswith("bias"):
            leaf = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, variables)


# family -> (tpu_asr's model class name, its config, the port's config,
# the flax variables both start from). The hybrid keeps flax_params as
# they are, for joint decode against tpu_asr's mesh Recognizer.
REFERENCE = {
    "hybrid": ("Transformer", lambda: jax_cfg(dropout=0.0),
               lambda: torch_cfg(dropout=0.0, pallas_ctc=True), flax_params),
    "cif": ("CifModel", lambda: cif_jax_cfg(dropout=0.0),
            lambda: cif_torch_cfg(dropout=0.0),
            lambda: _drawn_biases(cif_flax_params(), 1)),
    "transducer": ("TransducerModel",
                   lambda: transducer_jax_cfg(dropout=0.0, ctc_weight=0.3),
                   lambda: transducer_torch_cfg(dropout=0.0, ctc_weight=0.3),
                   lambda: _drawn_biases(transducer_flax_params(), 2)),
    "conformer": ("Transformer", lambda: conformer_jax_cfg(dropout=0.0),
                  lambda: conformer_torch_cfg(dropout=0.0),
                  lambda: _drawn_biases(conformer_flax_params(), 3)),
}


def _port_model(family):
    from tpu_asr_torch.models import build_model
    _, _, torch_cfg_of, variables = REFERENCE[family]
    model = build_model(torch_cfg_of())
    load_jax_params(model, variables())
    return model


FAMILIES = {family: functools.partial(_port_model, family)
            for family in REFERENCE}
DECODES = {   # case -> (family, mode, beam)
    "greedy_ctc": ("hybrid", "greedy_ctc", dict(beam=1, max_len=12)),
    "joint": ("hybrid", "joint", dict(beam=3, max_len=10, nbest=2,
                                      ctc_weight=0.3)),
    "attn_rescore": ("hybrid", "attn_rescore",
                     dict(beam=3, max_len=10, nbest=2, ctc_weight=0.3)),
    "cif_greedy": ("cif", "cif_greedy", dict(beam=1, max_len=12)),
    "transducer_greedy": ("transducer", "transducer_greedy",
                          dict(beam=1, max_len=12)),
}
TRAIN_CASES = [f"{family}/{batch}" for family in FAMILIES
               for batch in BATCHES] + ["hybrid/specaug"]


def _cases() -> dict:
    models = {name: build() for name, build in FAMILIES.items()}
    cases = {}
    for name in TRAIN_CASES:
        family, batch = name.split("/")
        model = models[family]
        cases[name] = {"kind": "train", "mesh": "2x2", "model": model,
                       "d_model": model.cfg.d_model,
                       "batch": BATCHES.get(batch, UNEVEN),
                       "specaug": SPECAUG if batch == "specaug" else None}
    for name, (family, mode, beam) in DECODES.items():
        cases[f"decode/{name}"] = {
            "kind": "decode", "mesh": "4x1", "model": models[family],
            "cfg": models[family].cfg, "mode": mode, "beam": beam,
            "batch": DECODE_BATCH}
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case, on its mesh and in one process: one spawn of four
    ranks for the whole module."""
    d = tmp_path_factory.mktemp("parallel")
    cases, out = d / "cases.pt", d / "results.pt"
    torch.save(_cases(), cases)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, HERE]))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_parallel_ranks.py"),
         str(cases), str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "gloo on cpu" in proc.stderr      # the backend is printed
    results = {}
    for r in range(4):
        for name, got in torch.load(f"{out}.{r}", weights_only=False).items():
            results.setdefault(name, {}).update(got)
    return results


# ---- no process: the layout rules against tpu_asr.parallel ----

@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 2), (8, 1), (2, 4)])
def test_mesh_coordinates_match_reference(n_data, n_model):
    from tpu_asr.parallel import make_mesh
    devices = jax.devices()[: n_data * n_model]
    ids = np.vectorize(lambda d: devices.index(d))(
        make_mesh(n_data, n_model, devices=devices).devices)
    data_groups, model_groups = mesh_groups(n_data, n_model)
    assert data_groups == ids.T.tolist()     # a column: one model coord
    assert model_groups == ids.tolist()      # a row: one data coord


def _rank_mesh(r, n_data, n_model):
    return Mesh(n_data, n_model, r,
                Axis(None, n_data, r // n_model),
                Axis(None, n_model, r % n_model))


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (8, 1)])
def test_shard_batch_matches_addressable_shards(n_data, n_model):
    from tpu_asr.parallel import make_mesh
    from tpu_asr.parallel import shard_batch as jax_shard_batch
    devices = jax.devices()[: n_data * n_model]
    batch = make_batch((61,) * 8, (3,) * 8)
    placed = jax_shard_batch(batch, make_mesh(n_data, n_model,
                                              devices=devices))
    for r in range(n_data * n_model):
        mine = shard_batch(dict(batch, ids=["x"]), _rank_mesh(r, n_data,
                                                              n_model))
        assert "ids" not in mine
        for key, arr in placed.items():
            shard, = [s for s in arr.addressable_shards
                      if s.device == devices[r]]
            np.testing.assert_array_equal(mine[key], np.asarray(shard.data))


def _flax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _reference_shapes(family):
    """The flax params' shapes of a family (jax.eval_shape of its init:
    no values computed) and the port's model of the same config."""
    from tpu_asr.models import CifModel, Transformer, TransducerModel
    from tpu_asr_torch.models import build_model
    jcfg, tcfg, model = {
        "hybrid": (jax_cfg(), torch_cfg(pallas_ctc=True), Transformer),
        "cif": (cif_jax_cfg(), cif_torch_cfg(), CifModel),
        "transducer": (transducer_jax_cfg(), transducer_torch_cfg(),
                       TransducerModel),
        "conformer": (conformer_jax_cfg(), conformer_torch_cfg(),
                      Transformer)}[family]
    shapes = jax.eval_shape(
        model(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 80)),
        jnp.full((1,), 80, jnp.int32), jnp.zeros((1, 4), jnp.int32),
        jnp.full((1,), 4, jnp.int32))["params"]
    return shapes, build_model(tcfg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rules_split_the_reference_axes(family):
    """For every flax leaf, the port's rule splits the torch weight where
    tpu_asr's _spec_for splits the flax one: cutting the flax leaf (its
    shape filled with distinct values) into two blocks along its 'model'
    axis and converting each gives the two blocks of the converted leaf
    along the port's dim."""
    from jax.tree_util import DictKey
    from tpu_asr.parallel.sharding import _spec_for
    shapes, model = _reference_shapes(family)
    specs = param_specs(model)
    n_sharded = 0
    for path, shape in _flax_leaves(shapes):
        leaf = np.arange(np.prod(shape.shape), dtype=np.float32).reshape(
            shape.shape)
        spec = tuple(_spec_for(tuple(DictKey(k) for k in path), leaf))
        name, full = flax_to_torch("/".join(path), leaf)
        dim = specs[name]
        if "model" not in spec:
            assert dim is None, name
            continue
        n_sharded += 1
        axis = spec.index("model")
        halves = np.split(leaf, 2, axis=axis)
        for half, want in zip(halves, np.split(full, 2, axis=dim)):
            np.testing.assert_array_equal(
                flax_to_torch("/".join(path), half)[1], want, err_msg=name)
    assert n_sharded == sum(d is not None for d in specs.values()) > 0


# ---- the four ranks ----

def _assert_step_equal(got, want, what):
    (gm, gg, ge), (wm, wg, we) = got, want
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{what} {k}")
    assert gg.keys() == wg.keys()
    for k in wg:
        np.testing.assert_allclose(gg[k].numpy(), wg[k].numpy(), **GRAD_TOL,
                                   err_msg=f"{what} {k}")
    for k in we:
        np.testing.assert_allclose(ge[k], we[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{what} eval {k}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_mesh_step_equals_single_process(ranks, case):
    got, want = ranks[case]["mesh"], ranks[case]["single"]
    _assert_step_equal(got, want, case)
    assert np.isfinite(got[0]["loss"]) and got[0]["grad_norm"] > 0


def test_all_dummy_shard_carries_no_loss(ranks):
    """The losses of a batch whose second shard is all dummy rows are the
    losses of its real rows alone (a shard of dummies adds 0, not NaN)."""
    for family in FAMILIES:
        metrics = ranks[f"{family}/dummy_shard"]["mesh"][0]
        assert all(np.isfinite(v) for v in metrics.values()), family


@pytest.mark.parametrize("case", list(DECODES))
def test_mesh_decode_equals_single_process(ranks, case):
    got = ranks[f"decode/{case}"]["mesh"]
    want = ranks[f"decode/{case}"]["single"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for hg, hw in zip(g, w):
            assert hg["yseq"] == hw["yseq"], case
            assert abs(hg["score"] - hw["score"]) <= 1e-5, case
            assert hg.get("times") == hw.get("times"), case


# ---- every family against tpu_asr's own mesh ----

def _keep_gradients() -> optax.GradientTransformation:
    """An optimizer whose state is the last gradients and whose update is
    0: make_train_step then hands back its gradient tree."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _reference_mesh_step(family, batch):
    """tpu_asr's make_train_step (jitted) on make_mesh(4, 2) with
    shard_params, from the family's flax variables -> (metrics, the
    gradient tree)."""
    import tpu_asr.models
    from tpu_asr.parallel import make_mesh, replicated
    from tpu_asr.parallel import shard_batch as jax_shard_batch
    from tpu_asr.parallel.sharding import shard_params
    from tpu_asr.train import TrainState, make_train_step
    cls, jax_cfg_of, _, variables = REFERENCE[family]
    tx = _keep_gradients()
    state = TrainState.create(variables()["params"], tx,
                              jax.random.PRNGKey(1))
    mesh = make_mesh(n_data=4, n_model=2)
    state = state.replace(
        params=shard_params(state.params, mesh),
        opt_state=jax.device_put(state.opt_state, replicated(mesh)),
        step=jax.device_put(state.step, replicated(mesh)),
        rng=jax.device_put(state.rng, replicated(mesh)))
    step = make_train_step(getattr(tpu_asr.models, cls)(jax_cfg_of()), tx,
                           donate=False)
    state, metrics = step(state, jax_shard_batch(batch, mesh))
    return ({k: float(v) for k, v in metrics.items()},
            jax.device_get(state.opt_state))


def _check_against_reference(ranks, family):
    """The port's dp 2 x tp 2 step on UNEVEN against tpu_asr's mesh step
    from the same params and batch: the metrics within LOSS_RTOL, every
    gradient (gathered whole on the port's side) within GRAD_TOL."""
    metrics, grads = _reference_mesh_step(family, UNEVEN)
    got, got_grads, _ = ranks[f"{family}/uneven"]["mesh"]
    assert got.keys() == metrics.keys()
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=f"{family} {k}")
    names = set()
    for path, leaf in _flax_leaves(grads):
        name, want = flax_to_torch("/".join(path), leaf)
        names.add(name)
        np.testing.assert_allclose(got_grads[name].numpy(), want,
                                   **GRAD_TOL, err_msg=f"{family} {name}")
    assert names == set(got_grads)


def test_hybrid_mesh_step_matches_reference(ranks):
    """The port's dp 2 x tp 2 step against tpu_asr's make_train_step on
    make_mesh(4, 2) with shard_params, from the same params and batch:
    metrics and gradients."""
    _check_against_reference(ranks, "hybrid")


@pytest.mark.parametrize("family", ["cif", "transducer", "conformer"])
def test_family_mesh_step_matches_reference(ranks, family):
    _check_against_reference(ranks, family)


def test_joint_mesh_decode_matches_reference(ranks):
    from tpu_asr.decode.beam import BeamConfig as JaxBeam
    from tpu_asr.decode.recognizer import Recognizer as JaxRecognizer
    from tpu_asr.parallel import make_mesh
    _, _, beam = DECODES["joint"]
    want = JaxRecognizer(
        cfg=jax_cfg(), params=flax_params(), mode="joint",
        beam=JaxBeam(**beam),
        mesh=make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    ).decode_batch_nbest(DECODE_BATCH)
    got = ranks["decode/joint"]["mesh"]
    for g, w in zip(got, want):
        for hg, hw in zip(g, w):
            assert hg["yseq"] == hw["yseq"]
            assert abs(hg["score"] - hw["score"]) <= 1e-4
    assert any(h[0]["yseq"] for h in got)

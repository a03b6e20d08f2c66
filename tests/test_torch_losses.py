"""Port sequence losses (tpu_asr_torch.ops.losses) and the hybrid objective
(Transformer.forward) vs tpu_asr on the CPU.

Tolerances: rtol/atol 1e-6 for the losses (float32 log_softmax and sums
on both sides); 1e-5 for the whole model's losses (the encoder's float32
matmuls sum in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr import IGNORE_ID
from tpu_asr.models import Transformer as JaxTransformer
from tpu_asr.models.transformer import add_sos_eos as jax_add_sos_eos
from tpu_asr.ops.losses import label_smoothing_loss as jax_ls_loss
from tpu_asr.ops.losses import masked_row_mean as jax_row_mean
from tpu_asr.ops.losses import token_accuracy as jax_accuracy
from tpu_asr_torch.models.transformer import add_sos_eos
from tpu_asr_torch.ops.losses import (label_smoothing_loss, masked_row_mean,
                                      token_accuracy)
from torch_port_util import VOCAB, flax_params, jax_cfg, torch_model

TOL = dict(rtol=1e-6, atol=1e-6)


def _targets(rng, b=4, u=7, v=VOCAB):
    t = rng.integers(0, v, (b, u)).astype(np.int32)
    lens = np.array([u, 3, 0, 5], np.int32)[:b]
    for i, n in enumerate(lens):
        t[i, n:] = IGNORE_ID
    return t, lens


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_smoothing_and_accuracy_match(smoothing, dtype):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 7, VOCAB)).astype(np.float32)
    targets, _ = _targets(rng)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want, n_want = jax_ls_loss(jl, jnp.asarray(targets), smoothing)
    got, n_got = label_smoothing_loss(tl, torch.from_numpy(targets).long(),
                                      smoothing)
    assert int(n_got) == int(n_want)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(
        token_accuracy(tl, torch.from_numpy(targets).long()).item(),
        float(jax_accuracy(jl, jnp.asarray(targets))), **TOL)


def test_label_smoothing_gradient_matches():
    import jax
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 7, VOCAB)).astype(np.float32)
    targets, _ = _targets(rng)
    want = jax.grad(lambda x: jax_ls_loss(x, jnp.asarray(targets), 0.1)[0])(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    label_smoothing_loss(tl, torch.from_numpy(targets).long(), 0.1)[0] \
        .backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(want), **TOL)


def test_masked_row_mean_and_sos_eos_match():
    rng = np.random.default_rng(2)
    per_row = rng.standard_normal(5).astype(np.float32)
    valid = np.array([True, False, True, True, False])
    np.testing.assert_allclose(
        masked_row_mean(torch.from_numpy(per_row),
                        torch.from_numpy(valid)).item(),
        float(jax_row_mean(jnp.asarray(per_row), jnp.asarray(valid))), **TOL)
    assert masked_row_mean(torch.ones(2), torch.zeros(2, dtype=torch.bool)
                           ).item() == 0.0
    targets, lens = _targets(rng)
    j_in, j_out = jax_add_sos_eos(jnp.asarray(targets), jnp.asarray(lens),
                                  VOCAB - 2, VOCAB - 1)
    t_in, t_out = add_sos_eos(torch.from_numpy(targets).long(),
                              torch.from_numpy(lens), VOCAB - 2, VOCAB - 1)
    np.testing.assert_array_equal(t_in.numpy(), np.asarray(j_in))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_hybrid_objective_matches():
    """Transformer.forward (loss, loss_att, loss_ctc, acc) from the same
    flax params and batch, with a dummy row (feat_lengths 0)."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((4, 53, 80)).astype(np.float32)
    flens = np.array([53, 40, 0, 29], np.int32)
    targets, tlens = _targets(rng, v=VOCAB - 2)
    want = JaxTransformer(jax_cfg()).apply(
        flax_params(), jnp.asarray(feats), jnp.asarray(flens),
        jnp.asarray(targets), jnp.asarray(tlens))
    model = torch_model().train()
    got = model(torch.from_numpy(feats), torch.from_numpy(flens),
                torch.from_numpy(targets), torch.from_numpy(tlens))
    assert set(got) == {"loss", "loss_att", "loss_ctc", "acc"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)

"""Port exact_top_k vs jax.lax.top_k: values AND indices, ties included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_asr_torch.ops.topk import exact_top_k

NEG_INF = -1e30


def _check(x, k):
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = exact_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("shape,k", [((5, 4233), 10), ((40, 4233), 21),
                                     ((8, 60), 5), ((3, 7), 7)])
def test_random_rows(shape, k):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _check(x, k)


def test_ties_break_by_smallest_index():
    rng = np.random.default_rng(1)
    # few distinct values: many ties inside and across the top k
    x = rng.integers(0, 4, (6, 300)).astype(np.float32)
    _check(x, 17)


def test_neg_inf_rows():
    """Finished beams and beams 1..W-1 at step 0 sit at NEG_INF: the order
    among them must be the reference's."""
    x = np.full((4, 50), NEG_INF, np.float32)
    x[1, [3, 7]] = 0.0
    x[2, :] = np.where(np.arange(50) % 11 == 0, 0.0, NEG_INF)
    x[3, 10:] = -np.inf
    _check(x, 5)
    _check(x, 12)


def test_leading_dims():
    x = np.random.default_rng(2).standard_normal((2, 3, 40)).astype(
        np.float32)
    _check(x, 4)

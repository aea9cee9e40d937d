"""The port's embedding scatter-add, the gather's backward (its plain
version, on the CPU), against the JAX package's Pallas
``_scatter_kernel`` run in interpret mode and the gradient of its
``embedding_lookup`` with the Pallas path forced (FLAGS_pallas_force,
restored by the fixture).  Bitwise: both sum the rows of an id in
sorted (stable) order, left to right.

Covers colliding ids, BERT's 2-row sentence table with every id on
row 0, out-of-range ids (clipped, as the forward clips them) and
padding_idx (whose rows get no cotangent).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.ops.pallas import embedding as jemb

import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as temb

D = 24


@pytest.fixture
def force_pallas():
    j_set_flags({'FLAGS_pallas_force': True})
    yield
    j_set_flags({'FLAGS_pallas_force': J_DEFAULTS['FLAGS_pallas_force']})


def _case(kind, rng):
    if kind == 'collisions':
        v = 530
        ids = np.array([0, 5, 5, 5, 2, 529, 2, 5, 0, 0] * 7, np.int64)
    elif kind == 'sentence_table':
        v = 2
        ids = np.zeros(256, np.int64)
    elif kind == 'positions':
        v = 64
        ids = np.tile(np.arange(64), 4).astype(np.int64)
    else:
        v = 600
        ids = rng.randint(0, v, 300).astype(np.int64)
    g = rng.randn(ids.size, D).astype('float32')
    return v, ids, g


@pytest.mark.parametrize('kind', ['collisions', 'sentence_table',
                                  'positions', 'random'])
def test_scatter_add_matches_pallas_bitwise(kind):
    v, ids, g = _case(kind, np.random.RandomState(0))
    want = np.asarray(jemb.scatter_add(v, jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(g), True))
    before = common.launches('embedding_scatter_add')
    got = temb.scatter_add(v, torch.from_numpy(ids), torch.from_numpy(g))
    assert common.launches('embedding_scatter_add') == before  # CPU: plain
    assert got.shape == (v, D) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = np.setdiff1d(np.arange(v), ids)
    assert np.all(got.numpy()[untouched] == 0.0)


def test_scatter_add_sums_in_sorted_order():
    """Row 0 of a run is summed left to right: ((g0 + g1) + g2) ..., in
    the order the ids came (a stable sort)."""
    g = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    ids = torch.tensor([3, 3, 3, 3])
    got = temb.scatter_add_plain(4, ids, g)
    want = ((g[0] + g[1]) + g[2]) + g[3]
    assert got[3].item() == want.item() == 1.0
    got = temb.scatter_add_plain(4, torch.tensor([3, 1, 3, 3]), g)
    assert got[3].item() == (((g[0] + g[2]) + g[3])).item()
    assert got[1].item() == 1.0


@pytest.mark.parametrize('padding_idx', [-1, 5])
def test_lookup_grad_matches_pallas_vjp_bitwise(force_pallas, padding_idx):
    rng = np.random.RandomState(1)
    v = 520
    w = rng.randn(v, 8).astype('float32')
    ids = np.array([[0, 5, 5, 5, 2], [519, 2, 5, 0, 0]], np.int64)
    cot = rng.randn(2, 5, 8).astype('float32')

    def f(w):
        return jemb.embedding_lookup(w, jnp.asarray(ids), padding_idx)

    _, vjp = jax.vjp(f, jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    tw = torch.from_numpy(w).requires_grad_()
    out = temb.embedding_lookup(tw, torch.from_numpy(ids), padding_idx)
    (got,) = torch.autograd.grad(out, tw, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.numpy(), want)
    if padding_idx >= 0:
        assert np.all(got.numpy()[padding_idx] == 0.0)


def test_lookup_grad_clips_out_of_range_ids():
    w = torch.zeros(6, 3, requires_grad=True)
    ids = torch.tensor([-4, 0, 5, 9, 2])
    out = temb.embedding_lookup(w, ids)
    (got,) = torch.autograd.grad(out.sum(), w)
    np.testing.assert_array_equal(got[:, 0].numpy(), [2, 0, 1, 0, 0, 2])


def test_scatter_kernel_rejects_bad_inputs():
    with pytest.raises(TypeError, match='f32 rows'):
        temb.scatter_add_kernel(4, torch.zeros(2, dtype=torch.int64),
                                torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match=r'ids \[n\] and g \[n, D\]'):
        temb.scatter_add_kernel(4, torch.zeros(3, dtype=torch.int64),
                                torch.zeros(2, 3))

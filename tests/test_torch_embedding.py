"""The port's embedding lookup (its plain version, on the CPU) against
the JAX package's Pallas gather kernel forced in interpret mode
(FLAGS_pallas_force, V >= 512).  Bitwise: a gather copies rows.

Covers duplicate ids, ids outside [0, V-1] (both clip) and padding_idx
(rows zeroed outside the kernel).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.ops.pallas import embedding as jemb

import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import embedding as temb

V, D = 640, 48


@pytest.fixture(autouse=True)
def _force_pallas():
    j_set_flags({'FLAGS_pallas_force': True})
    yield
    j_set_flags({'FLAGS_pallas_force': J_DEFAULTS['FLAGS_pallas_force']})


def _ids(rng, shape):
    ids = rng.randint(0, V, shape).astype('int64')
    flat = ids.reshape(-1)
    flat[:4] = [5, 5, 5, V - 1]          # duplicates and the last row
    flat[4:8] = [-1, -7, V, V + 1000]    # out of range: clipped
    return ids


@pytest.mark.parametrize('padding_idx', [-1, 5, 0])
@pytest.mark.parametrize('shape', [(37,), (3, 17)])
def test_embedding_lookup_matches_pallas_bitwise(padding_idx, shape):
    rng = np.random.RandomState(1)
    w = rng.randn(V, D).astype('float32')
    ids = _ids(rng, shape)
    want = np.asarray(jemb.embedding_lookup(jnp.asarray(w),
                                            jnp.asarray(ids), padding_idx))
    before = common.launches('embedding_lookup')
    got = temb.embedding_lookup(torch.from_numpy(w), torch.from_numpy(ids),
                                padding_idx)
    assert common.launches('embedding_lookup') == before  # CPU: plain
    assert got.shape == shape + (D,)
    np.testing.assert_array_equal(got.numpy(), want)
    if padding_idx >= 0:
        assert np.all(got.numpy()[ids == padding_idx] == 0.0)


def test_gather_plain_is_clipped_index_select():
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.randn(V, D).astype('float32'))
    ids = torch.from_numpy(_ids(rng, (20,)))
    for id_dtype in (torch.int64, torch.int32):
        got = temb.gather_plain(w, ids.to(id_dtype))
        want = w.numpy()[np.clip(ids.numpy(), 0, V - 1)]
        np.testing.assert_array_equal(got.numpy(), want)


def test_gather_kernel_rejects_bad_inputs():
    w = torch.zeros(V, D)
    with pytest.raises(TypeError, match='int64 or int32'):
        temb.gather_kernel(w, torch.zeros(4))
    with pytest.raises(ValueError, match=r'w \[V, D\] and ids \[n\]'):
        temb.gather_kernel(w, torch.zeros(2, 2, dtype=torch.int64))


def test_kernel_registry_and_report():
    info = common.kernels()
    assert set(info) == {'embedding_lookup', 'embedding_scatter_add',
                         'embedding_update', 'flash_attention',
                         'flash_attention_bwd', 'fused_adam', 'fused_lamb',
                         'quant_quantize', 'quant_reduce', 'dropout',
                         'dropout_grad', 'graph_cond', 'finite_check'}
    assert info['embedding_lookup']['op_types'] == ('lookup_table',
                                                    'lookup_table_v2')
    assert info['embedding_scatter_add']['replaces'].startswith(
        'paddle_tpu/ops/pallas/embedding.py:65')
    assert info['flash_attention']['replaces'].startswith(
        'paddle_tpu/ops/pallas/flash_attention.py:121')
    saved = {k: common.launches(k) for k in info}
    try:
        common.reset_launches()
        assert common.report() == {}
        common.count_launch('embedding_lookup')
        rep = common.report()['kernels']
        assert list(rep) == ['embedding_lookup']
        assert rep['embedding_lookup']['launches'] == 1
        assert rep['embedding_lookup']['source'] == 'embedding_gather.cu'
    finally:
        for k, n in saved.items():
            common.KERNELS[k]['launches'] = n


def test_use_kernel_dispatch_rule():
    cpu = torch.zeros(2)
    assert common.use_kernel(cpu, None) is False
    assert common.use_kernel(torch.empty(2, device='meta')) is False
    with pytest.raises(ValueError, match='mixed devices'):
        common.use_kernel(cpu, torch.empty(2, device='meta'))

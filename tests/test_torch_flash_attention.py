"""The port's flash attention (its plain version, on the CPU) against the
JAX package's Pallas kernel run in interpret mode (min_seq=0).

Shapes B=2, T=128, H=2, D=16 in f32; with and without a key bias,
causal and not, and a batch row whose keys are all masked (key bias
-inf), where both must give O = 0 and lse = log(1e-20).  Tolerance
atol 2e-5 / rtol 1e-5 on O and lse: f32 on both sides, summed in
different orders over 128 keys.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa

import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

B, T, H, D = 2, 128, 2, 16
TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(seed, bias_kind):
    rng = np.random.RandomState(seed)
    q, k, v = [rng.randn(B, T, H, D).astype('float32') for _ in range(3)]
    if bias_kind is None:
        bias = None
    else:
        bias = np.where(rng.rand(B, T) < 0.3, -10000.0,
                        rng.randn(B, T)).astype('float32')
        if bias_kind == 'row_masked':
            bias[1, :] = -np.inf
    return q, k, v, bias


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('bias_kind', [None, 'padding', 'row_masked'])
def test_flash_attention_matches_pallas_interpret(causal, bias_kind):
    q, k, v, bias = _inputs(3, bias_kind)
    jq, jk, jv, jb = _jax(q, k, v, bias)
    want = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal,
                                          key_bias=jb, min_seq=0))
    tq, tk, tv, tb = _torch(q, k, v, bias)
    before = common.launches('flash_attention')
    got = tfa.flash_attention(tq, tk, tv, causal=causal, key_bias=tb)
    assert common.launches('flash_attention') == before  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if bias_kind == 'row_masked':
        assert np.all(got.numpy()[1] == 0.0)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('bias_kind', [None, 'padding', 'row_masked'])
def test_flash_attention_with_lse_matches_pallas_interpret(causal,
                                                           bias_kind):
    q, k, v, bias = _inputs(5, bias_kind)
    jo, jlse = jfa.flash_attention_with_lse(*_jax(q, k, v), causal=causal,
                                            key_bias=_jax(bias)[0])
    to, tlse = tfa.flash_attention_with_lse(*_torch(q, k, v),
                                            causal=causal,
                                            key_bias=_torch(bias)[0])
    assert tlse.dtype == torch.float32 and tlse.shape == (B, H, T)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    if bias_kind == 'row_masked':
        np.testing.assert_allclose(tlse.numpy()[1],
                                   np.float32(np.log(1e-20)), rtol=1e-6)


def test_flash_attention_reads_strided_views():
    """Q/K/V as the split views of one fused projection (the BERT
    layout) give the same answer as contiguous copies."""
    rng = np.random.RandomState(0)
    qkv = torch.from_numpy(rng.randn(B, T, 3 * H * D).astype('float32'))
    q, k, v = [t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=2)]
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_flash_attention_dropout_raises():
    """Attention dropout needs the seed its mask is keyed on (the
    dropout branch itself: tests/test_torch_flash_dropout.py)."""
    q, k, v, _ = _inputs(0, None)
    tq, tk, tv = _torch(q, k, v)
    with pytest.raises(ValueError, match='dropout_rate > 0 needs a '
                                         'dropout_seed'):
        tfa.flash_attention(tq, tk, tv, dropout_rate=0.1)
    with pytest.raises(ValueError, match='dropout_rate > 0 needs a '
                                         'dropout_seed'):
        tfa.flash_attention_with_lse(tq, tk, tv, dropout_rate=0.1)


def test_flash_attention_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match='head dim 48'):
        tfa.flash_attention_kernel(q, q, q)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match='f32 or bf16'):
        tfa.flash_attention_kernel(q, q, q)
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match=r'key_bias must be \[B, T\]'):
        tfa.flash_attention_kernel(q, q, q, key_bias=torch.zeros(1, 4))

"""The port's flash attention with in-kernel attention dropout, forward
and backward (its plain versions, on the CPU), against the JAX
package's Pallas kernels run in interpret mode.

Shapes B=2, T=128, H=2, D=16 in f32, dropout rate 0.1.  The keep mask
is compared bitwise with the JAX package's ``dropout_keep_dense`` (the
dense twin of the in-kernel hash).  O and lse are held to atol 2e-5 /
rtol 1e-5 (f32 on both sides, summed in different orders over 128
keys); dQ, dK, dV and the key-bias gradient to atol 5e-5 / rtol 1e-5
(the same sums, with one more product and, for the bias, a sum over
queries and heads).  The backward is checked against both JAX
schedules: the fused one-pass kernel (`FUSED_BWD`, the default) and
the two-pass dq / dkv kernels; the fixture restores the flag.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.pallas import flash_attention as jfa

import torch

from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

B, T, H, D = 2, 128, 2, 16
RATE = 0.1
SEED = 0x9E3779B9 ^ 4242
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
BWD_TOL = dict(atol=5e-5, rtol=1e-5)


@pytest.fixture
def fused_bwd():
    """Set the JAX package's FUSED_BWD for one test, then restore it."""
    saved = jfa.FUSED_BWD
    yield lambda on: setattr(jfa, 'FUSED_BWD', on)
    jfa.FUSED_BWD = saved


def _inputs(seed, bias_kind):
    rng = np.random.RandomState(seed)
    q, k, v, do = [rng.randn(B, T, H, D).astype('float32')
                   for _ in range(4)]
    glse = rng.randn(B, H, T).astype('float32')
    bias = None
    if bias_kind is not None:
        bias = np.where(rng.rand(B, T) < 0.3, -10000.0,
                        rng.randn(B, T)).astype('float32')
        if bias_kind == 'row_masked':
            bias[1, :] = -np.inf
    return q, k, v, bias, do, glse


def _t(a, grad=False):
    if a is None:
        return None
    x = torch.from_numpy(a)
    return x.requires_grad_() if grad else x


@pytest.mark.parametrize('seed,b,h,t', [(SEED, B, H, T), (1, 3, 4, 64),
                                        (0xFFFFFFFF, 1, 12, 96)])
def test_keep_mask_is_the_jax_hash_bitwise(seed, b, h, t):
    want = np.asarray(jfa.dropout_keep_dense(jnp.uint32(seed), b, h, t, t,
                                             rate=RATE))
    got = tfa.dropout_keep_plain(seed, b, h, t, t, RATE).numpy()
    assert got.shape == (b, h, t, t)
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - RATE)) < 0.02


def test_keep_threshold_matches_jax():
    for rate in (0.0, 0.1, 0.25, 0.5, 0.9):
        assert tfa.keep_threshold(rate) == jfa._keep_threshold(rate)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('bias_kind', [None, 'padding', 'row_masked'])
def test_dropout_forward_matches_pallas_interpret(causal, bias_kind):
    q, k, v, bias, _, _ = _inputs(3, bias_kind)
    jo, jlse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        key_bias=None if bias is None else jnp.asarray(bias),
        dropout_rate=RATE, dropout_seed=jnp.uint32(SEED))
    before = common.launches('flash_attention')
    to, tlse = tfa.flash_attention_with_lse(
        _t(q), _t(k), _t(v), causal=causal, key_bias=_t(bias),
        dropout_rate=RATE, dropout_seed=SEED)
    assert common.launches('flash_attention') == before  # CPU: plain
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD_TOL)
    if bias_kind == 'row_masked':
        assert np.all(to.numpy()[1] == 0.0)


@pytest.mark.parametrize('fused', [True, False])
@pytest.mark.parametrize('bias_kind', [None, 'padding', 'row_masked'])
def test_dropout_grads_match_pallas_interpret(fused_bwd, fused, bias_kind):
    fused_bwd(fused)
    q, k, v, bias, do, glse = _inputs(5, bias_kind)
    prim = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        prim.append(jnp.asarray(bias))

    def f(q, k, v, *b):
        return jfa.flash_attention_with_lse(
            q, k, v, key_bias=b[0] if b else None, dropout_rate=RATE,
            dropout_seed=jnp.uint32(SEED))

    _, vjp = jax.vjp(f, *prim)
    want = vjp((jnp.asarray(do), jnp.asarray(glse)))
    leaves = [_t(x, grad=True) for x in (q, k, v)]
    tb = _t(bias, grad=True)
    to, tlse = tfa.flash_attention_with_lse(*leaves, key_bias=tb,
                                            dropout_rate=RATE,
                                            dropout_seed=SEED)
    wrt = leaves + ([tb] if tb is not None else [])
    got = torch.autograd.grad([to, tlse], wrt, [_t(do), _t(glse)])
    for name, g, w in zip(('dq', 'dk', 'dv', 'dbias'), got, want):
        w = np.asarray(w)
        if name == 'dbias' and bias_kind == 'row_masked':
            # the fully masked row: both give a zero cotangent
            np.testing.assert_array_equal(g.numpy()[1], 0.0)
            g, w = g[:1], w[:1]
        np.testing.assert_allclose(np.asarray(g), w, err_msg=name,
                                   **BWD_TOL)


def test_plain_backward_is_autograd_of_the_function():
    """The Function's backward (flash_attention_bwd_plain on the CPU)
    equals autograd straight through flash_attention_plain."""
    q, k, v, bias, do, glse = _inputs(7, 'padding')
    leaves = [_t(x, grad=True) for x in (q, k, v, bias)]
    o, lse = tfa.flash_attention_with_lse(*leaves[:3], key_bias=leaves[3],
                                          dropout_rate=RATE,
                                          dropout_seed=SEED)
    got = torch.autograd.grad([o, lse], leaves, [_t(do), _t(glse)])
    leaves2 = [_t(x, grad=True) for x in (q, k, v, bias)]
    o2, lse2 = tfa.flash_attention_plain(*leaves2[:3], False, leaves2[3],
                                         RATE, SEED)
    want = torch.autograd.grad([o2, lse2], leaves2, [_t(do), _t(glse)])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_dropout_seed_matches_the_jax_lowering_context():
    """The fused attention op keys its mask on LowerCtx.dropout_seed:
    the same uint32 as the JAX package's for every (op seed, step)."""
    for op_seed in (0, 1, 1000003, 2 ** 31 - 1):
        for step in (1, 2, 3, 4, 1000, 2 ** 20 + 7):
            want = int(jregistry.LowerCtx(step, op_seed).dropout_seed({}))
            got = tregistry.LowerCtx(step, op_seed).dropout_seed({})
            assert got == want, (op_seed, step)
    assert tregistry.LowerCtx(1, 5).dropout_seed({'is_test': True}) is None
    assert tregistry.LowerCtx(1, 5, prefer_test=True).dropout_seed({}) \
        is None


def test_bwd_kernel_rejects_what_it_does_not_take():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match='needs a dropout_seed'):
        tfa.flash_attention_bwd_kernel(q, q, q, None, q, None, q, None,
                                       dropout_rate=0.1)
    with pytest.raises(ValueError, match='do must be'):
        tfa.flash_attention_bwd_kernel(q, q, q, None, q, None,
                                       torch.zeros(1, 8, 2, 32), None)

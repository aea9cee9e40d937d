"""The products, losses and length-sized ops of the attention-chain
slice against the JAX package, on the CPU: matmul (both transposes,
alpha, batched with broadcast batch dims, a 1-D operand), matmul_v2,
bmm, log_softmax, label_smooth (with and without a prior),
softmax_with_cross_entropy with soft labels, position_encoding and
causal_mask_like; each forward and its gradient (autograd against
jax.vjp) from the same numpy inputs (tests/torch_attention_cases.py).

Tolerances, and why:
- label_smooth and causal_mask_like: bitwise (the same f32 scale and
  add, a constant), but for the prior's gradient, a sum over the rows
  the prior was broadcast to (rtol 1e-5 as below);
- matmul, matmul_v2, bmm, log_softmax and the soft-label loss: rtol
  1e-5 with a floor of 1e-5 of the largest magnitude: each sums in an
  order of its own (XLA's dot and reductions against PyTorch's);
- position_encoding: atol 2**-22 against the JAX package (both compute
  the angle pos / 10000^(2 floor(i/2) / D) in f32 in the same order, so
  the angles agree and each side's sin / cos lies within an f32 ulp of
  the same value, at most 2**-23 near 1); and against float64 within 2
  ulps of the largest angle plus 2 ulps of 1: the f32 angle carries the
  rounding of the power and of the quotient, and sin / cos move by as
  much as their argument.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

from paddle_tpu_torch.ops import math_ops

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch

_R = np.random.RandomState(4)


def _f(*shape):
    return _R.randn(*shape).astype('float32')


def _soft(*shape):
    p = np.abs(_f(*shape))
    return (p / p.sum(-1, keepdims=True)).astype('float32')


def _smooth_labels(n, depth):
    return np.eye(depth, dtype='float32')[_R.randint(0, depth, n)]


CASES = [
    ('matmul_2d', 'matmul', {'X': [_f(3, 4)], 'Y': [_f(4, 5)]}, {}, 1e-5),
    # the attention scores: Q K^T scaled, [B, H, T, D] x [B, H, T, D]
    ('matmul_scores', 'matmul', {'X': [_f(2, 3, 6, 8)], 'Y': [_f(2, 3, 6, 8)]},
     {'transpose_Y': True, 'alpha': 8 ** -0.5}, 1e-5),
    ('matmul_tx_broadcast', 'matmul',
     {'X': [_f(2, 3, 5, 4)], 'Y': [_f(3, 5, 6)]},
     {'transpose_X': True, 'alpha': 0.3}, 1e-5),
    ('matmul_both_t', 'matmul', {'X': [_f(2, 4, 3)], 'Y': [_f(2, 5, 4)]},
     {'transpose_X': True, 'transpose_Y': True}, 1e-5),
    ('matmul_1d', 'matmul', {'X': [_f(4)], 'Y': [_f(2, 4, 3)]}, {}, 1e-5),
    ('matmul_v2', 'matmul_v2', {'X': [_f(2, 5, 4)], 'Y': [_f(2, 3, 4)]},
     {'trans_y': True}, 1e-5),
    ('bmm', 'bmm', {'X': [_f(2, 3, 4)], 'Y': [_f(2, 4, 5)]}, {}, 1e-5),
    ('log_softmax_last', 'log_softmax', {'X': [_f(3, 4, 7) * 5]},
     {'axis': -1}, 1e-5),
    ('log_softmax_axis1', 'log_softmax', {'X': [_f(3, 4, 7) * 5]},
     {'axis': 1}, 1e-5),
    ('label_smooth', 'label_smooth', {'X': [_smooth_labels((3, 4), 5)]},
     {'epsilon': 0.1}, 0),
    ('label_smooth_prior', 'label_smooth',
     {'X': [_smooth_labels((3, 4), 5)], 'PriorDist': [_soft(1, 5)]},
     {'epsilon': 0.2}, 0, 1e-5),
    ('soft_label_ce', 'softmax_with_cross_entropy',
     {'Logits': [_f(3, 4, 7) * 3], 'Label': [_soft(3, 4, 7)]},
     {'soft_label': True}, 1e-5),
    ('soft_label_ce_axis1', 'softmax_with_cross_entropy',
     {'Logits': [_f(3, 7, 4) * 3], 'Label': [_soft(3, 4, 7).transpose(
         0, 2, 1).copy()]},
     {'soft_label': True, 'axis': 1}, 1e-5),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, attrs, tol = case[:5]
    check(op, ins, attrs, tol, *case[5:])


def _pe64(t, d):
    pos = np.arange(t, dtype='float64')[:, None]
    i = np.arange(d, dtype='float64')[None, :]
    angle = pos / np.power(10000.0, 2 * np.floor(i / 2) / d)
    return np.where(np.arange(d) % 2 == 0, np.sin(angle), np.cos(angle))


@pytest.mark.parametrize('t', [1, 17, 256])
def test_position_encoding_matches_jax(t):
    d = 512
    ins = {'X': [_f(2, t, d)]}
    want = run_jax('position_encoding', ins, {'d_model': d})['Out'][0]
    got = run_torch('position_encoding', ins, {'d_model': d})['Out'][0]
    assert got.shape == want.shape == (1, t, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -22)
    bound = 2.0 ** -23 * (2 * (t - 1) + 2)
    for pe in (got, np.asarray(want)):
        np.testing.assert_allclose(pe[0], _pe64(t, d), rtol=0, atol=bound)


@pytest.mark.parametrize('t', [1, 9])
def test_causal_mask_like_matches_jax(t):
    check('causal_mask_like', {'X': [_f(2, t, 4)]}, {}, 0)
    got = run_torch('causal_mask_like', {'X': [_f(2, t, 4)]}, {})['Out'][0]
    assert got.shape == (1, 1, t, t)
    np.testing.assert_array_equal(got[0, 0] == 0, np.tril(np.ones((t, t))))


def test_products_run_without_tf32_forward_and_backward(monkeypatch):
    """_Matmul, the route of an f32 product on the card while
    torch.backends.cuda.matmul.allow_tf32 is True, runs its forward and
    both backward products with the flag off (autograd runs the
    backward after the forward's context has closed) and puts it back;
    its gradients are summed over broadcast batch dims."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    x = torch.randn(2, 3, 4, requires_grad=True)
    y = torch.randn(4, 5, requires_grad=True)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        monkeypatch.setattr(torch, 'matmul', spy)
        out = math_ops._Matmul.apply(x, y)
        gx, gy = torch.autograd.grad(out.sum(), [x, y])
        monkeypatch.undo()
        assert seen == [False, False, False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        monkeypatch.undo()
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.testing.assert_close(out, x.detach() @ y.detach())
    torch.testing.assert_close(gx, torch.ones(2, 3, 5) @ y.detach().T)
    torch.testing.assert_close(gy, (x.detach().transpose(1, 2) @
                                    torch.ones(2, 3, 5)).sum(0))

"""The activation op types of the core slice (the JAX package's
ops/activation_ops.py beyond the port's first ten) on the CPU against
the JAX package, each forward and its gradient (torch.autograd over the
port's lowering against jax.vjp over the JAX package's; the grad op of
each registry) from the same numpy inputs and seeded cotangents.

Inputs hold the piecewise functions' breakpoints exactly (0, +-threshold,
the clamp bounds of hard_sigmoid and hard_swish at -3 and 3, relu6's 6),
where a clamp taken in another order would round or split its gradient
otherwise (abs at 0 takes the gradient of its positive branch, as
jnp.abs).  Tolerance (torch_attention_cases.check): every forward and
gradient within rtol TOL = 1e-5 plus 1e-5 of its largest magnitude, f32
on both sides.
"""

import numpy as np
import pytest

from torch_attention_cases import check

TOL = 1e-5


def _x(seed=0, shape=(4, 6), scale=2.0):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * scale).astype('float32')
    flat = x.reshape(-1)
    # the breakpoints of the piecewise activations, exactly
    for i, v in enumerate((0.0, -3.0, 3.0, 6.0, 0.5, -0.5, 1.0, -1.0)):
        flat[i] = v
    return x


def _unit(seed=1, shape=(4, 6)):
    """Inputs in (-0.95, 0.95), for acos / asin / atanh-like domains."""
    r = np.random.RandomState(seed)
    return (r.uniform(-0.95, 0.95, shape)).astype('float32')


def _pos(seed=2, shape=(4, 6)):
    r = np.random.RandomState(seed)
    return (r.uniform(0.1, 3.0, shape)).astype('float32')


# (op types, input maker, attrs); inputs chosen inside each op's domain
CASES = [
    (('abs', 'ceil'), _x, {}),
    (('round', 'square'), _x, {}),
    (('rsqrt', 'log2', 'log10', 'log1p'), _pos, {}),
    (('sin', 'tan'), _unit, {}),
    (('acos', 'asin'), _unit, {}),
    (('atan', 'sinh', 'cosh'), _x, {}),
    (('erf', 'softsign'), _x, {}),
    (('softplus', 'logsigmoid'), _x, {}),
    (('silu', 'tanh_shrink'), _x, {}),
    (('leaky_relu',), _x, {'alpha': 0.1}),
    (('elu',), _x, {'alpha': 1.3}),
    (('relu6', 'brelu'), _x, {'threshold': 6.0, 't_min': -1.0,
                              't_max': 3.0}),
    (('hard_sigmoid',), _x, {'slope': 1.0 / 6, 'offset': 0.5}),
    (('hard_sigmoid',), _x, {}),
    (('hard_swish',), _x, {}),
    (('swish', 'mish'), _x, {'beta': 1.7}),
    (('thresholded_relu', 'hard_shrink'), _x, {'threshold': 1.0}),
    (('soft_shrink', 'softshrink'), _x, {'lambda': 0.5}),
    (('selu', 'stanh'), _x, {}),
]


@pytest.mark.parametrize('ops,make,attrs', CASES,
                         ids=['-'.join(c[0]) for c in CASES])
def test_activation_matches_jax(ops, make, attrs):
    x = make()
    for op in ops:
        check(op, {'X': [x]}, attrs, TOL)


@pytest.mark.parametrize('mode', ['all', 'channel', 'element'])
def test_prelu_matches_jax(mode):
    x = _x(shape=(2, 3, 4, 5))
    r = np.random.RandomState(3)
    shape = {'all': (1,), 'channel': (3,), 'element': (3, 4, 5)}[mode]
    alpha = r.uniform(0.0, 0.5, shape).astype('float32')
    check('prelu', {'X': [x], 'Alpha': [alpha]}, {'mode': mode}, TOL)


def test_maxout_matches_jax_with_ties():
    """Equal channels in a group: the gradient splits among them as
    jnp.max's does (amax)."""
    x = _x(shape=(2, 6, 3, 3))
    x[:, 1] = x[:, 0]
    check('maxout', {'X': [x]}, {'groups': 2}, TOL)

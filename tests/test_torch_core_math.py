"""The math op types of the core slice (the JAX package's
ops/math_ops.py beyond the port's first ones: the reductions, dot, the
finite checks, p_norm, arg_min, top_k_v2, argsort, norm, cholesky and
inverse) on the CPU against the JAX package, forward and gradient
(torch_attention_cases.check: torch.autograd over the port's lowering
against jax.vjp over the JAX package's).

Tolerances: bitwise (tol 0) where the JAX result is exact: reduce_all /
reduce_any, the finite flags, arg_min, the sort and top-k indices and
values, and the max / min reductions' values; every other forward and
gradient within rtol TOL = 1e-5 plus 1e-5 of its largest magnitude
(f32 on both sides, other summation orders).  Ties are in the inputs
where the order or the gradient depends on them: the first minimum of
arg_min, the lower index first among equal values of argsort and
top_k_v2, and an even split of reduce_max's gradient among equal
maxima.
"""

import numpy as np
import pytest

from torch_attention_cases import check
from torch_image_cases import run_jax, run_torch

TOL = 1e-5


def _x(shape=(3, 4, 5), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype('float32')


def _ties(shape=(3, 8), seed=0):
    """Values from a few levels, so equal values share rows."""
    r = np.random.RandomState(seed)
    return r.randint(-2, 3, shape).astype('float32')


REDUCE_ATTRS = [
    {'dim': [1], 'keep_dim': False},
    {'dim': [0, -1], 'keep_dim': True},
    {'reduce_all': True, 'dim': [0]},
]


@pytest.mark.parametrize('op', ['reduce_mean', 'reduce_prod'])
def test_reduce_float_matches_jax(op):
    x = _x()
    if op == 'reduce_prod':
        x = (np.sign(x) * (0.5 + np.abs(x) % 1.0)).astype('float32')
    for attrs in REDUCE_ATTRS:
        check(op, {'X': [x]}, attrs, TOL)


@pytest.mark.parametrize('op', ['reduce_max', 'reduce_min'])
def test_reduce_extreme_bitwise_with_ties(op):
    """The values bitwise; the gradient split evenly among equal
    extremes, as jnp.max / jnp.min's."""
    x = _ties((3, 4, 5))
    for attrs in REDUCE_ATTRS:
        check(op, {'X': [x]}, attrs, 0, grad_tol=TOL)


@pytest.mark.parametrize('op', ['reduce_all', 'reduce_any'])
def test_reduce_bool_bitwise(op):
    r = np.random.RandomState(4)
    for x in (r.rand(3, 4, 5) > 0.2, (r.rand(3, 4) > 0.5).astype('float32'),
              np.ones((2, 3), bool)):
        for attrs in REDUCE_ATTRS[:1] + [{'reduce_all': True, 'dim': []},
                                         {'dim': [], 'keep_dim': False}]:
            check(op, {'X': [x]}, attrs, 0)


def test_dot_matches_jax():
    check('dot', {'X': [_x((5,))], 'Y': [_x((5,), 1)]}, {}, TOL)
    check('dot', {'X': [_x((4, 5))], 'Y': [_x((4, 5), 1)]}, {}, TOL)


def test_finite_flags_bitwise():
    """One flag over every input, not a mask (JAX math_ops.py:139)."""
    fine = _x((3, 4))
    inf = fine.copy()
    inf[1, 2] = np.inf
    nan = fine.copy()
    nan[0, 0] = np.nan
    for op in ('isfinite', 'isinf', 'isnan'):
        for xs in ([fine], [fine, inf], [nan], [fine, fine, nan, inf]):
            want, got = run_jax(op, {'X': xs}, {}), run_torch(op, {'X': xs},
                                                              {})
            assert got['Out'][0].shape == () == want['Out'][0].shape
            assert got['Out'][0].dtype == np.bool_
            np.testing.assert_array_equal(got['Out'][0], want['Out'][0])


@pytest.mark.parametrize('attrs', [
    {'porder': 2.0, 'axis': -1},
    {'porder': 3.0, 'axis': 1, 'keepdim': True},
    {'porder': 1.0, 'axis': 0}])
def test_p_norm_matches_jax(attrs):
    check('p_norm', {'X': [_x()]}, attrs, TOL)


def test_arg_min_first_of_ties_bitwise():
    x = _ties()
    for axis in (-1, 0):
        check('arg_min', {'X': [x]}, {'axis': axis}, 0)


def test_top_k_v2_stable_on_ties_bitwise():
    x = _ties((4, 10))
    check('top_k_v2', {'X': [x]}, {'k': 4}, 0, grad_tol=TOL)


@pytest.mark.parametrize('descending', [False, True])
def test_argsort_stable_on_ties_bitwise(descending):
    x = _ties((4, 10))
    for axis in (-1, 0):
        check('argsort', {'X': [x]}, {'axis': axis,
                                      'descending': descending}, 0,
              grad_tol=TOL)


def test_norm_matches_jax():
    for attrs in ({'axis': 1, 'epsilon': 1e-10}, {'axis': -1,
                                                  'epsilon': 1e-6}):
        check('norm', {'X': [_x()]}, attrs, TOL)


def _spd(n=4, batch=(2,), seed=5):
    a = np.random.RandomState(seed).randn(*(batch + (n, n)))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype('float32')


def test_cholesky_matches_jax():
    """Forward and the gradient of the symmetric input (both packages
    symmetrize it), within 1e-4: the factor's gradient solves two
    triangular systems in f32."""
    check('cholesky', {'X': [_spd()]}, {}, 1e-4)


def test_inverse_matches_jax():
    a = _spd(batch=())
    a += np.triu(np.full_like(a, 0.3), 1)  # not symmetric
    check('inverse', {'Input': [a]}, {}, 1e-4)

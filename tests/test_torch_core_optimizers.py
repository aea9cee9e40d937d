"""The optimizer classes of the core slice on the CPU against the JAX
package: LarsMomentum, Adamax, Adadelta, RMSProp (with and without
centering), Ftrl, Dpsgd, DecayedAdagrad, DGCMomentum, ModelAverage,
ExponentialMovingAverage and Lookahead.

Each builds the same program in both packages (same_program: the same
ops, accumulators and startup fills) on a small classifier (two fc
layers, softmax_with_cross_entropy) and trains 3 steps in lockstep:
before each step the port takes the JAX package's whole state, then
the loss and every state variable after the step agree within rtol
TOL = 1e-5 plus 1e-5 of its largest magnitude (f32 on both sides, the
gradients summed in other orders).  Dpsgd's noise comes from the port's
counter hash: its lockstep runs at sigma 0 (its noise is held by
statistics in test_torch_core_optimizer_ops.py).  ModelAverage's
apply() and restore() write into the scope's tensors (the same storage
before and after) and give the JAX package's averaged and restored
parameters.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import core as tcore

from torch_attention_cases import close
from torch_program_cases import build_both, same_program

TOL = 1e-5
B, D, H, C = 8, 6, 16, 4


def _net(fluid):
    x = fluid.layers.data('x', [D], dtype='float32')
    y = fluid.layers.data('y', [1], dtype='int64')
    h = fluid.layers.fc(x, H, act='relu')
    logits = fluid.layers.fc(h, C)
    return fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits, y))


def _feeds(n=3, seed=0):
    r = np.random.RandomState(seed)
    return [{'x': r.randn(B, D).astype('float32'),
             'y': r.randint(0, C, (B, 1)).astype('int64')}
            for _ in range(n)]


def _lockstep(progs, feeds):
    """(JAX scope, port scope) after the steps; each port step from the
    JAX package's state before it."""
    jm, js, jl = progs['jax']
    tm, ts, tl = progs['torch']
    names = weights.startup_names(ts)
    assert names == weights.startup_names(js)
    steps = []
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        for feed in feeds:
            before = weights.numpy_state(jscope, names)
            loss, = exe.run(jm, feed=feed, fetch_list=[jl])
            steps.append((before, np.asarray(loss),
                          weights.numpy_state(jscope, names)))
    tscope = tfluid.Scope()
    place = tfluid.CPUPlace()
    with tfluid.scope_guard(tscope):
        exe = tfluid.Executor(place)
        exe.run(ts)
        for feed, (before, want, want_state) in zip(feeds, steps):
            weights.load_numpy_params(tscope, before, place, ts)
            loss, = exe.run(tm, feed=feed, fetch_list=[tl])
            close(np.asarray(loss).reshape(want.shape), want, TOL, 'loss')
            got = weights.numpy_state(tscope, names)
            for n in names:
                close(got[n].reshape(want_state[n].shape).astype(
                    want_state[n].dtype) if got[n].dtype.kind == 'i'
                    else got[n], want_state[n], TOL, n)
    return jscope, tscope


def _build(make_opt, wrap=None):
    def build(fluid):
        loss = _net(fluid)
        opt = make_opt(fluid.optimizer)
        if wrap is not None:
            return wrap(fluid, opt, loss)
        opt.minimize(loss)
        return loss
    progs = build_both(build, seed=11)
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])
    return progs


OPTIMIZERS = {
    'lars_momentum': lambda o: o.LarsMomentum(0.1, 0.9, lars_coeff=0.01),
    'adamax': lambda o: o.Adamax(0.01),
    'adadelta': lambda o: o.Adadelta(1.0, rho=0.9),
    'rmsprop': lambda o: o.RMSProp(0.01, rho=0.9, epsilon=1e-3,
                                   momentum=0.9),
    'rmsprop_centered': lambda o: o.RMSPropOptimizer(
        0.01, rho=0.9, epsilon=1e-3, momentum=0.5, centered=True),
    'ftrl': lambda o: o.Ftrl(0.1, l1=0.01, l2=0.01),
    'dpsgd': lambda o: o.Dpsgd(0.1, clip=0.5, sigma=0.0),
    'decayed_adagrad': lambda o: o.DecayedAdagrad(0.05, decay=0.9),
    'dgc_momentum': lambda o: o.DGCMomentumOptimizer(0.1, 0.9,
                                                     sparsity=[0.75]),
}


@pytest.mark.parametrize('kind', sorted(OPTIMIZERS))
def test_optimizer_trains_in_lockstep_with_jax(kind):
    progs = _build(OPTIMIZERS[kind])
    types = [op.type for op in progs['torch'][0].global_block().ops]
    op_type = {'rmsprop_centered': 'rmsprop', 'dgc_momentum': 'dgc'}.get(
        kind, kind)
    assert types.count(op_type) == 4
    _lockstep(progs, _feeds())


def test_exponential_moving_average_in_lockstep():
    """RMSProp + EMA(0.9): the `<param>.ema` variables follow the
    JAX package's, and the EMA ops come after the updates."""
    def wrap(fluid, opt, loss):
        opt.minimize(loss)
        fluid.optimizer.ExponentialMovingAverage(0.9).update()
        return loss
    progs = _build(OPTIMIZERS['rmsprop'], wrap)
    names = weights.startup_names(progs['torch'][1])
    assert sum(n.endswith('.ema') for n in names) == 4
    types = [op.type for op in progs['torch'][0].global_block().ops]
    assert types[-3:] == ['scale', 'scale', 'elementwise_add']
    _lockstep(progs, _feeds())


def test_lookahead_in_lockstep():
    """k = 2 over 3 steps: the slow weights sync at step 2 only."""
    def wrap(fluid, opt, loss):
        fluid.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=2).minimize(
            loss)
        return loss
    progs = _build(lambda o: o.SGD(0.1), wrap)
    jscope, tscope = _lockstep(progs, _feeds())
    slow = [n for n in weights.startup_names(progs['torch'][1])
            if n.endswith('@SLOW')]
    assert len(slow) == 4


def test_model_average_apply_and_restore_like_jax():
    """Sums and count in lockstep; apply() puts sum / count into the
    parameters' own tensors and restore() puts them back, as the JAX
    package's apply / restore give them."""
    holder = {}

    def wrap(fluid, opt, loss):
        opt.minimize(loss)
        holder[fluid] = fluid.optimizer.ModelAverage(0.15)
        return loss
    progs = _build(lambda o: o.Momentum(0.1, 0.9), wrap)
    jscope, tscope = _lockstep(progs, _feeds())
    params = [p.name for p in
              progs['torch'][0].global_block().all_parameters()]
    with jfluid.scope_guard(jscope):
        before_j = weights.numpy_state(jscope, params)
        with holder[jfluid].apply():
            avg_j = weights.numpy_state(jscope, params)
        after_j = weights.numpy_state(jscope, params)
    with tfluid.scope_guard(tscope):
        storage = {n: tcore.as_array(tscope.find_var(n)).data_ptr()
                   for n in params}
        before_t = weights.numpy_state(tscope, params)
        with holder[tfluid].apply():
            avg_t = weights.numpy_state(tscope, params)
            assert all(tcore.as_array(tscope.find_var(n)).data_ptr() ==
                       storage[n] for n in params)
        after_t = weights.numpy_state(tscope, params)
    for n in params:
        close(before_t[n], before_j[n], TOL, n)
        close(avg_t[n], avg_j[n], TOL, n)
        np.testing.assert_array_equal(after_t[n], before_t[n])
        np.testing.assert_array_equal(after_j[n], before_j[n])
        assert not np.allclose(avg_t[n], before_t[n])


def test_lookahead_slow_weights_are_their_own_tensors():
    """From the port's own startup (its assign ops copy each parameter
    into its slow weights), k = 2: the first step moves the fast weights
    and leaves the slow ones at the startup values; the second syncs
    them, after which fast and slow are equal.  Slow weights aliasing
    the parameters would follow their in-place update at step 1."""
    progs = _build(lambda o: o.SGD(0.1), lambda fluid, opt, loss: (
        fluid.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=2).minimize(
            loss), loss)[1])
    tm, ts, tl = progs['torch']
    names = weights.startup_names(ts)
    slow = [n for n in names if n.endswith('@SLOW')]
    fast = [n[:-len('@SLOW')] for n in slow]
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        scope = tfluid.global_scope()
        start = weights.numpy_state(scope, fast)
        steps = []
        for feed in _feeds(2):
            exe.run(tm, feed=feed, fetch_list=[tl])
            steps.append(weights.numpy_state(scope, names))
    for f, sl in zip(fast, slow):
        np.testing.assert_array_equal(steps[0][sl], start[f])
        assert not np.array_equal(steps[0][f], start[f])
        np.testing.assert_array_equal(steps[1][sl], steps[1][f])
        assert not np.array_equal(steps[1][sl], start[f])

"""The port's batch_norm against the JAX package's, on the CPU: the op
(Y, MeanOut, VarianceOut, SavedMean, SavedVariance and the gradients of
X, Scale and Bias) in training and in test mode, both layouts; the
running statistics against their formula in float64; the layer's
Program; a training step through the executor, whose moving
statistics reach the scope detached and carry no gradient; and the
tiny SE-ResNeXt built with is_test, whose batch_norms normalize by the
running statistics.
Tolerances (tests/torch_image_cases.py): forward rtol 1e-5 with a floor
of 1e-5 of the largest output, gradients within 1e-4 of the largest.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

from paddle_tpu.models import se_resnext as jse
from paddle_tpu_torch.models import se_resnext as tse

from torch_image_cases import (assert_forward_close, check_op, programs,
                               run_torch, same_block, se_resnext_tiny_build)

_R = np.random.RandomState(0)


def _ins(x, c):
    return {'X': [x.astype('float32')],
            'Scale': [(1.0 + 0.1 * _R.randn(c)).astype('float32')],
            'Bias': [(0.1 * _R.randn(c)).astype('float32')],
            'Mean': [(0.2 * _R.randn(c)).astype('float32')],
            'Variance': [(1.0 + _R.rand(c)).astype('float32')]}


@pytest.mark.parametrize('layout', ['NCHW', 'NHWC'])
def test_batch_norm_train_matches_jax(layout):
    x = _R.randn(4, 3, 5, 6) * 2.0 + 0.5
    if layout == 'NHWC':
        x = x.transpose(0, 2, 3, 1)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
             'data_layout': layout, 'use_global_stats': False}
    check_op('batch_norm', _ins(x, 3), attrs, seed=4)


def test_batch_norm_large_mean_is_shifted():
    """A channel mean of 1e3 with std 1: the statistics taken about the
    first batch element's mean keep the variance (the raw-sum form
    E[x^2] - E[x]^2 loses it to cancellation in f32); the port agrees
    with the JAX package and with float64 to 1e-4."""
    x = _R.randn(8, 2, 6, 6) + 1e3
    ins = _ins(x, 2)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
             'data_layout': 'NCHW', 'use_global_stats': False}
    check_op('batch_norm', ins, attrs, seed=5)
    got = run_torch('batch_norm', ins, attrs)
    x32 = ins['X'][0].astype(np.float64)
    var64 = x32.var(axis=(0, 2, 3))
    np.testing.assert_allclose(got['SavedVariance'][0],
                               1.0 / np.sqrt(var64 + 1e-5), rtol=1e-4)
    np.testing.assert_allclose(got['SavedMean'][0], x32.mean(axis=(0, 2, 3)),
                               rtol=1e-6)


def test_batch_norm_running_statistics_formula():
    """MeanOut = momentum * Mean + (1 - momentum) * batch mean (the
    reverse of torch's momentum argument), VarianceOut the same over the
    unbiased batch variance (n / (n - 1)), SavedVariance
    rsqrt(batch variance + epsilon), against float64."""
    x = _R.randn(3, 2, 4, 5) * 1.5 - 0.3
    ins = _ins(x, 2)
    attrs = {'momentum': 0.8, 'epsilon': 1e-3, 'is_test': False,
             'data_layout': 'NCHW', 'use_global_stats': False}
    got = run_torch('batch_norm', ins, attrs)
    x64 = ins['X'][0].astype(np.float64)
    n = 3 * 4 * 5
    m = x64.mean(axis=(0, 2, 3))
    v = x64.var(axis=(0, 2, 3))
    mean0 = ins['Mean'][0].astype(np.float64)
    var0 = ins['Variance'][0].astype(np.float64)
    np.testing.assert_allclose(got['MeanOut'][0], 0.8 * mean0 + 0.2 * m,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got['VarianceOut'][0],
                               0.8 * var0 + 0.2 * v * n / (n - 1), rtol=1e-5)
    np.testing.assert_allclose(got['SavedVariance'][0],
                               1.0 / np.sqrt(v + 1e-3), rtol=1e-5)
    y = (x64 - m[None, :, None, None]) / np.sqrt(v + 1e-3)[None, :, None,
                                                            None]
    y = y * ins['Scale'][0][None, :, None, None] + \
        ins['Bias'][0][None, :, None, None]
    np.testing.assert_allclose(got['Y'][0], y, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('flag', ['is_test', 'use_global_stats'])
def test_batch_norm_global_stats_match_jax(flag):
    """is_test or use_global_stats: normalized by the running
    statistics, which come back unchanged; SavedVariance is their
    rsqrt(var + epsilon)."""
    x = _R.randn(2, 5, 3, 3).transpose(0, 2, 3, 1)
    ins = _ins(x, 5)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
             'data_layout': 'NHWC', 'use_global_stats': False}
    attrs[flag] = True
    want, got = check_op('batch_norm', ins, attrs, seed=6)
    np.testing.assert_array_equal(got['MeanOut'][0], ins['Mean'][0])
    np.testing.assert_array_equal(got['VarianceOut'][0], ins['Variance'][0])


def test_batch_norm_bf16_matches_jax():
    """bf16 input: the raw sums in f32 (as in the JAX package), Y in
    bf16; the f32 side outputs agree to the f32 tolerance, Y to one
    bf16 ulp (2^-8 relative) of its largest magnitude."""
    x = _R.randn(4, 3, 4, 4) * 2.0 + 1.0
    ins = _ins(x, 3)
    attrs = {'momentum': 0.9, 'epsilon': 1e-5, 'is_test': False,
             'data_layout': 'NCHW', 'use_global_stats': False}
    import jax.numpy as jnp
    from paddle_tpu.ops import registry as jreg
    from paddle_tpu_torch.ops import registry as treg
    jx = {k: [jnp.asarray(v[0])] for k, v in ins.items()}
    jx['X'] = [jx['X'][0].astype(jnp.bfloat16)]
    tx = {k: [torch.from_numpy(v[0])] for k, v in ins.items()}
    tx['X'] = [tx['X'][0].to(torch.bfloat16)]
    want = jreg.get('batch_norm').run(jreg.LowerCtx(1, 0), jx, attrs)
    got = treg.get('batch_norm').run(treg.LowerCtx(1, 0), tx, attrs)
    assert got['Y'][0].dtype == torch.bfloat16
    assert_forward_close(
        {k: [np.asarray(v[0])] for k, v in want.items() if k != 'Y'},
        {k: [v[0].numpy()] for k, v in got.items() if k != 'Y'})
    wy = np.asarray(want['Y'][0].astype(jnp.float32))
    gy = got['Y'][0].float().numpy()
    assert np.abs(gy - wy).max() <= 2.0 ** -8 * np.abs(wy).max()


def _bn_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[3, 6, 6])
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        y = fluid.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
        y = fluid.layers.batch_norm(y, act='relu', momentum=0.8)
        y = fluid.layers.pool2d(y, pool_type='avg', global_pooling=True)
        logits = fluid.layers.fc(y, 5)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return main, startup, loss


def test_batch_norm_layer_builds_like_jax():
    """Scale and bias are trainable; the moving mean and variance are
    non-trainable persistable parameters with stop_gradient, written in
    place (MeanOut / VarianceOut are the same variables); the grad op
    and the momentum ops (conv filter, scale, bias, fc weight and bias)
    are the JAX package's."""
    jm, js, _ = _bn_program(jfluid)
    tm, ts, _ = _bn_program(tfluid)
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    same_block(js.to_dict()['blocks'][0], ts.to_dict()['blocks'][0])
    bn = [op for op in tm.global_block().ops if op.type == 'batch_norm'][0]
    assert bn.outputs['MeanOut'] == bn.inputs['Mean']
    assert bn.outputs['VarianceOut'] == bn.inputs['Variance']
    mean = tm.global_block().var(bn.inputs['Mean'][0])
    assert mean.persistable and not mean.trainable and mean.stop_gradient
    types = [op.type for op in tm.global_block().ops]
    assert 'batch_norm_grad' in types and types.count('momentum') == 5


def test_batch_norm_step_matches_jax_and_detaches_statistics():
    """Two training steps in both packages from the JAX package's
    startup values: the losses (rtol 1e-5), the moving statistics and
    the parameters (1e-4 of their largest) agree; in the port's scope
    the moving statistics are plain tensors (no autograd history), and
    the whole-program grad takes no gradient through them."""
    rng = np.random.RandomState(1)
    feeds = [{'x': rng.randn(4, 3, 6, 6).astype('float32') + 2.0,
              'label': rng.randint(0, 5, (4, 1)).astype('int64')}
             for _ in range(2)]
    jm, js, jl = _bn_program(jfluid)
    tm, ts, tl = _bn_program(tfluid)
    names = weights.startup_names(ts)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        state = weights.numpy_state(jscope, names)
        jloss = [float(np.asarray(jexe.run(jm, feed=f, fetch_list=[jl])[0]))
                 for f in feeds]
        jend = weights.numpy_state(jscope, names)
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(), ts)
        tloss = [float(texe.run(tm, feed=f, fetch_list=[tl])[0])
                 for f in feeds]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    # scale w_0 and bias w_1 (with velocities), moving mean w_2 and
    # variance w_3
    assert sorted(n for n in names if n.startswith('batch_norm_0.')) == [
        'batch_norm_0.w_0', 'batch_norm_0.w_0_velocity_0', 'batch_norm_0.w_1',
        'batch_norm_0.w_1_velocity_0', 'batch_norm_0.w_2', 'batch_norm_0.w_3']
    for n in names:
        v = tscope.find_var(n)
        assert not v.requires_grad and v.grad_fn is None, n
        err = np.abs(v.numpy() - jend[n]).max() / np.abs(jend[n]).max()
        assert err <= 1e-4, (n, err)
    for n in ('batch_norm_0.w_2', 'batch_norm_0.w_3'):
        assert not np.array_equal(tscope.find_var(n).numpy(), state[n])


@pytest.fixture
def tiny_se_resnext(monkeypatch):
    monkeypatch.setitem(jse.DEPTH_CFG, 8, [1, 1, 1, 1])
    monkeypatch.setitem(tse.DEPTH_CFG, 8, [1, 1, 1, 1])


def test_se_resnext_eval_is_deterministic_like_jax(tiny_se_resnext):
    """test_se_resnext.py's eval check in the port: the is_test build
    from the JAX package's startup values gives softmax rows that sum to
    1, the same output on a second run, and the JAX package's output
    (rtol 1e-5, floor 1e-6)."""
    progs = programs(se_resnext_tiny_build(is_test=True), seed=5)
    img = np.random.RandomState(1).rand(4, 3, 32, 32).astype('float32')
    feed = {'image': img, 'label': np.zeros((4, 1), np.int64)}
    jm, js, _, (jout,) = progs['jax']
    tm, ts, _, (tout,) = progs['torch']
    assert all(op.attrs['is_test'] for op in tm.global_block().ops
               if op.type == 'batch_norm')
    names = weights.startup_names(ts)
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        state = weights.numpy_state(jfluid.global_scope(), names)
        want = np.asarray(jexe.run(jm, feed=feed, fetch_list=[jout])[0])
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tfluid.global_scope(), state,
                                  tfluid.CPUPlace(), ts)
        o1 = texe.run(tm, feed=feed, fetch_list=[tout])[0]
        o2 = texe.run(tm, feed=feed, fetch_list=[tout])[0]
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_allclose(o1.sum(axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(o1, want, rtol=1e-5, atol=1e-6)

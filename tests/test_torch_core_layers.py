"""The layers and fluid names of the core slice through whole programs
on the CPU: each program is built by one function in both packages
(torch_program_cases.build_both), must serialize alike (same_program:
ops, inputs, outputs, attrs, variables), and runs from the JAX
package's startup state on the same numpy feeds (run_both).

Tolerance (assert_runs_close): integer and boolean fetches bitwise, float
fetches within rtol TOL = 1e-5 plus 1e-5 of their largest magnitude.
The random layers of a main program draw from the port's counter hash
on the device (uniform_random, gaussian_random,
uniform_random_batch_size_like), not jax threefry: their programs are
compared, and their values by range and shape.
"""

import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5


def _both(build, feeds, seed=3):
    progs = build_both(build, seed=seed)
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])
    out = run_both(progs, feeds)
    assert_runs_close(out, TOL)
    return progs, out


def _feed(shape=(4, 6), seed=0, name='x'):
    return {name: np.random.RandomState(seed).randn(*shape).astype(
        'float32')}


def test_reduction_and_flag_layers():
    def build(fluid):
        x = fluid.layers.data('x', [6], dtype='float32')
        L = fluid.layers
        return [L.reduce_mean(x), L.reduce_mean(x, dim=1, keep_dim=True),
                L.reduce_max(x, dim=[0]), L.reduce_min(x, dim=-1),
                L.reduce_prod(x, dim=1), L.reduce_all(L.greater_than(
                    x, L.fill_constant([1], 'float32', -5.0))),
                L.reduce_any(L.greater_than(x, L.fill_constant(
                    [1], 'float32', 1.0)), dim=[1]),
                L.has_inf(x), L.has_nan(x), L.isfinite(x),
                L.argmin(x, axis=1), L.argsort(x, axis=1)[0],
                L.argsort(x, axis=0, descending=True)[1]]
    feed = _feed()
    feed['x'][0, :3] = 0.25  # ties
    _both(build, [feed])


def test_math_layers_and_their_gradients():
    """gradients() of the sum of the layers' means with respect to the
    input and to prelu's alpha."""
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6], dtype='float32')
        x.stop_gradient = False
        w = L.create_parameter([6, 3], 'float32', name='w')
        outs = [L.elementwise_pow(L.abs(x), L.fill_constant(
                    [1], 'float32', 1.5)),
                L.mul(x, w), L.clip(x, -0.5, 0.7), L.clip_by_norm(x, 1.0),
                L.l2_normalize(x, axis=1), L.leaky_relu(x, 0.1),
                L.prelu(x, 'all')]
        total = L.sums([L.mean(o) for o in outs])
        grads = fluid.gradients(total, [x, w])
        return outs + grads
    _both(build, [_feed(), _feed(seed=1)])


def test_shape_and_index_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [3, 4, 5], dtype='float32')
        idx = L.data('idx', [2], dtype='int64', append_batch_size=False)
        nd = L.data('nd', [2, 2], dtype='int64', append_batch_size=False)
        upd = L.data('upd', [2, 3, 4, 5], dtype='float32',
                     append_batch_size=False)
        cond = L.greater_than(x, L.zeros_like(x))
        return ([L.flatten(x, axis=2), L.where(cond, x, L.scale(x, 2.0)),
                 L.cond_select(cond, L.zeros_like(x), x),
                 L.pad(x, [0, 0, 1, 0, 0, 2, 1, 1], 0.5),
                 L.gather_nd(x, nd), L.scatter(x, idx, upd),
                 L.strided_slice(x, [1, 3], [0, 4], [3, -1], [2, -2]),
                 L.expand_as(L.slice(x, [1], [0], [1]), x),
                 L.pad2d(x, [1, 0, 2, 1], mode='reflect'),
                 L.reverse(x, [1, 2]), L.maxout(x, 3)] +
                L.unstack(x, axis=1))
    r = np.random.RandomState(2)
    feed = _feed((2, 3, 4, 5))
    feed.update({'idx': np.array([1, 0], 'int64'),
                 'nd': np.array([[1, 2], [0, -1]], 'int64'),
                 'upd': r.randn(2, 3, 4, 5).astype('float32')})
    _both(build, [feed])


def test_activation_and_cumsum_layers():
    from paddle_tpu_torch.fluid.layers import ops as tops

    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6], dtype='float32')
        pos = L.scale(L.abs(x), 1.0, 0.1)
        unit = L.scale(L.tanh(x), 0.9)

        def arg(n):
            if n in ('rsqrt', 'sqrt', 'log', 'log2', 'log10', 'log1p',
                     'reciprocal'):
                return pos
            return unit if n in ('acos', 'asin') else x
        outs = [getattr(L, n)(arg(n)) for n in tops._UNARY]
        return outs + [L.gelu(x), L.gelu(x, approximate=True), L.elu(x, 0.7),
                       L.relu6(x), L.swish(x, 2.0), L.hard_sigmoid(x),
                       L.hard_swish(x), L.cumsum(x, axis=1),
                       L.cumsum(x, axis=1, exclusive=True, reverse=True),
                       L.brelu(x, 0.0, 1.0), L.selu(x), L.stanh(x)]
    feed = _feed()
    feed['x'].reshape(-1)[:4] = (-3.0, 3.0, 0.0, 6.0)
    _both(build, [feed])


def test_tensor_creation_layers():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [4, 6], dtype='float32', append_batch_size=False)
        g = L.create_global_var([2, 3], 0.5, 'float32', persistable=True,
                                name='gv')
        arr = L.create_array('float32')
        for i in range(3):
            L.array_write(L.scale(x, float(i + 1)),
                          L.fill_constant([1], 'int64', i), array=arr)
        joined, index = L.tensor_array_to_tensor(arr, axis=1)
        stacked, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        t = L.create_tensor('float32', name='ct')
        L.assign(x, t)
        return [L.elementwise_add(g, L.ones([2, 3], 'float32')), joined,
                index, stacked, t, L.eye(3, 4), L.eye(2, batch_shape=[3]),
                L.diag(L.reduce_sum(x, dim=0)), L.linspace(0.0, 1.0, 5)]
    _both(build, [_feed()])


def test_dice_loss_trains_like_jax():
    """dice_loss on a softmax as the loss of two SGD steps."""
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6], dtype='float32')
        y = L.data('y', [1], dtype='int64')
        loss = L.dice_loss(L.softmax(L.fc(x, 4)), y)
        fluid.optimizer.SGD(0.5).minimize(loss)
        return [loss]
    r = np.random.RandomState(5)
    feeds = [dict(_feed(seed=k), y=r.randint(0, 4, (4, 1)).astype('int64'))
             for k in range(2)]
    _both(build, feeds)


def test_step_counter_layer_counts_from_begin():
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6], dtype='float32')
        c = L.autoincreased_step_counter(begin=3, step=2)
        return [L.elementwise_add(L.reduce_sum(x), L.cast(c, 'float32')), c]
    progs, out = _both(build, [_feed()] * 3)
    assert [int(np.asarray(r[1]).ravel()[0]) for r in out['torch']] == \
        [3, 5, 7]
    assert progs['torch'][0].global_block().ops[0].type == 'increment'


def test_random_layers_programs_and_ranges():
    """The programs alike; values in range; a main program holding
    uniform_random draws on the device and may be captured in a CUDA
    graph (only a startup program's host draws are refused:
    tests/test_torch_random_draws.py)."""
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [6], dtype='float32')
        return [L.uniform_random([3, 4], min=-2.0, max=2.0, seed=1),
                L.gaussian_random([500], mean=1.0, std=0.1, seed=2),
                L.uniform_random_batch_size_like(x, [-1, 7], min=0.0,
                                                 max=0.5)]
    progs = build_both(build)
    same_program(progs['jax'][0], progs['torch'][0])
    tm, ts, fetch = progs['torch']
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        u, g, ub = exe.run(tm, feed=_feed(), fetch_list=fetch)
    assert u.shape == (3, 4) and -2.0 <= u.min() and u.max() < 2.0
    assert abs(g.mean() - 1.0) < 5 * 0.1 / np.sqrt(500)
    assert ub.shape == (4, 7) and 0.0 <= ub.min() and ub.max() < 0.5
    plan = texecutor._build_plan(tm, [v.name for v in fetch])
    assert plan.no_graph is None


def test_fluid_names():
    for name in ('gradients', 'name_scope', 'WeightNormParamAttr',
                 'is_compiled_with_cuda', 'require_version', 'init_on_cpu',
                 'load_op_library'):
        assert hasattr(tfluid, name) and hasattr(jfluid, name), name
    import torch
    assert tfluid.is_compiled_with_cuda() == (torch.version.cuda is not None)
    tfluid.require_version('0.1.0')
    tfluid.require_version('0.0.9', '0.1.5')
    for bad in (('0.2',), ('0.0.1', '0.0.9')):
        with pytest.raises(Exception, match='version'):
            tfluid.require_version(*bad)
    assert paddle_tpu_torch.__version__ == '0.1.0'
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        tfluid.load_op_library('libcustom.so')
    assert w and 'register' in str(w[0].message)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup), \
            tfluid.name_scope('block'), tfluid.init_on_cpu():
        x = tfluid.layers.data('x', [6], dtype='float32')
        y = tfluid.layers.fc(x, 2, param_attr=tfluid.WeightNormParamAttr(
            name='wn'))
    assert y.name.startswith('fc_0') and 'wn' in [
        p.name for p in main.global_block().all_parameters()]


def test_gradients_with_target_gradients_like_jax():
    """Two targets weighted by their target gradients: the weighted sum's
    gradient, as the JAX package's calc_gradient builds it."""
    def build(fluid):
        L = fluid.layers
        x = L.data('x', [4, 6], dtype='float32', append_batch_size=False)
        x.stop_gradient = False
        a = L.tanh(x)
        b = L.reduce_sum(L.square(x), dim=1, keep_dim=True)
        tg = L.fill_constant([4, 6], 'float32', 0.5)
        tb = L.fill_constant([4, 1], 'float32', -2.0)
        return fluid.gradients([a, b], [x], target_gradients=[tg, tb])
    _both(build, [_feed()])

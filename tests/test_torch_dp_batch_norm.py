"""The port's batch_norm in data parallel against the JAX package's, on
the CPU.

- ``with_data_parallel`` (the JAX package's one global computation
  under GSPMD): a batch_norm Program (X fed with its gradient wanted,
  loss mean(Y * C) for a fed cotangent C) on 2 and 4 gloo ranks, rank r
  fed its rows of a global batch of 8, against the JAX package's
  ``with_data_parallel`` over as many devices of the conftest's CPU
  mesh fed the whole batch: Y, MeanOut, VarianceOut, SavedMean,
  SavedVariance and the gradients of X, Scale and Bias, in NCHW and
  NHWC, and in a batch whose channel 0 has mean 1e3 and std 1 (the
  case the shift of the statistics exists for).
- ``sync_batch_norm`` in a ``_collective_dp`` program (GradAllReduce,
  one SGD step) on 2 ranks against the JAX package's ``run_collective``
  on a 2-device mesh: rank 0's outputs, the moving statistics and the
  updated Scale and Bias.
- ResNet-18 at 3 x 32 x 32 (10 classes, Momentum(0.01, 0.9)) on 2
  ranks of 4 rows against the JAX package's ``with_data_parallel``
  over 2 devices of batch 8, 2 steps in lockstep: before each step the
  ranks load the JAX package's state.

Tolerances (tests/torch_image_cases.py, and why there): the forward
outputs rtol 1e-5 with a floor of 1e-5 of the largest; the gradients
within 1e-4 of the largest; in the lockstep the loss within rel 1e-4,
the parameters and moving statistics within 1e-4 of their largest, the
velocities within 1e-2 of theirs.  The ranks sum their statistics and
gradients in gloo's order, XLA over the global batch in its own.
"""

import json
import os

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.models import resnet as tresnet

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

import torch_dist_cases
from torch_image_cases import (GRAD_TOL_OF_MAX, LOSS_RTOL, _state_close,
                               assert_forward_close)

BATCH = 8
WORLDS = (2, 4)
CASES = ('NCHW', 'NHWC', 'large_mean')
# 8 endpoints: the JAX package's transpiler takes its 1/nranks scale
# from the larger of the endpoints and the 8 CPU devices, so both
# packages scale by 1/8
ENDPOINTS = ['127.0.0.1:%d' % (6170 + i) for i in range(8)]
RESNET_STEPS = 2

_NETS = '''
def bn_program(fluid, case, sync=False):
    """batch_norm of a fed X (gradient wanted), loss mean(Y * C); with
    sync, one SGD step and the op renamed sync_batch_norm."""
    layout = 'NHWC' if case == 'NHWC' else 'NCHW'
    shape = [5, 6, 3] if layout == 'NHWC' else [3, 5, 6]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=shape, dtype='float32')
        x.stop_gradient = False
        c = fluid.layers.data('c', shape=shape, dtype='float32')
        y = fluid.layers.batch_norm(x, data_layout=layout)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(y, c))
        if sync:
            fluid.optimizer.SGD(0.1).minimize(loss)
        else:
            fluid.backward.append_backward(loss)
    bn = [op for op in main.global_block().ops
          if op.type == 'batch_norm'][0]
    if sync:
        for op in main.global_block().ops:
            if op.type in ('batch_norm', 'batch_norm_grad'):
                op.type = 'sync_' + op.type
    outs = {s: bn.output(s)[0] for s in
            ('Y', 'MeanOut', 'VarianceOut', 'SavedMean', 'SavedVariance')}
    grads = {s: main._grad_name_map[bn.input(s)[0]]
             for s in ('X', 'Scale', 'Bias')}
    return main, startup, loss, outs, grads


def resnet_program(fluid, resnet):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss, _ = resnet.build(image_shape=(3, 32, 32), class_dim=10,
                                     depth=18)
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
    return main, startup, loss
'''
exec(_NETS)


def _bn_feed(case, rng):
    x = rng.randn(BATCH, 3, 5, 6) * 2.0 + 0.5
    if case == 'large_mean':
        x[:, 0] = rng.randn(BATCH, 5, 6) + 1e3
    c = rng.randn(BATCH, 3, 5, 6)
    if case == 'NHWC':
        x, c = x.transpose(0, 2, 3, 1), c.transpose(0, 2, 3, 1)
    return {'x': np.ascontiguousarray(x, np.float32),
            'c': np.ascontiguousarray(c, np.float32)}


def _bn_state(rng):
    """Random scale, bias and running statistics of the program's
    batch_norm."""
    return {'batch_norm_0.' + k: (base + 0.2 * rng.rand(3)).astype('float32')
            for k, base in (('w_0', 1.0), ('b_0', 0.0), ('w_1', 0.0),
                            ('w_2', 1.0))}


_WORKER = torch_dist_cases.PRELUDE + _NETS + 'ENDPOINTS = %r\n' % ENDPOINTS \
    + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid.transpiler import GradAllReduce
from paddle_tpu_torch.models import resnet
out_dir = sys.argv[1]
place = fluid.CPUPlace()
cases = json.load(open(os.path.join(out_dir, 'cases.json')))
result = {}


def rows(feed):
    n = len(next(iter(feed.values()))) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in feed.items()}


def fetch_all(exe, prog, feed, names):
    got = exe.run(prog, feed=feed, fetch_list=names)
    return {n: np.asarray(v) for n, v in zip(names, got)}


for case, sync in cases:
    tag = ('sync_' if sync else '') + case
    feed = dict(np.load(os.path.join(out_dir, 'feed_%s.npz' % tag)))
    state = dict(np.load(os.path.join(out_dir, 'state_%s.npz' % tag)))
    main, startup, loss, outs, grads = bn_program(fluid, case, sync)
    if sync:
        GradAllReduce().transpile(startup, main, rank, ENDPOINTS,
                                  ENDPOINTS[rank])
    exe, scope = fluid.Executor(place), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, state, place)
        if sync:
            prog = main
            names = list(outs.values()) + [grads['X']]
        else:
            prog = fluid.CompiledProgram(main).with_data_parallel(loss.name)
            names = list(outs.values()) + list(grads.values())
        got = fetch_all(exe, prog, rows(feed), names)
        got.update(weights.numpy_state(scope, sorted(state)))
    if rank == 0:
        np.savez(os.path.join(out_dir, 'got_%s.npz' % tag), **got)

if world == 2:
    # ResNet-18 in lockstep: each step from the JAX package's state
    main, startup, loss = resnet_program(fluid, resnet)
    prog = fluid.CompiledProgram(main).with_data_parallel(loss.name)
    exe, scope = fluid.Executor(place), fluid.Scope()
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for step in range(%(steps)d):
            before = dict(np.load(os.path.join(out_dir,
                                               'before%%d.npz' %% step)))
            weights.load_numpy_params(scope, before, place, startup)
            feed = dict(np.load(os.path.join(out_dir,
                                             'feed%%d.npz' %% step)))
            losses.append(float(exe.run(prog, feed=rows(feed),
                                        fetch_list=[loss])[0]))
            after = weights.numpy_state(scope, sorted(before))
            if rank == 0:
                np.savez(os.path.join(out_dir, 'after%%d.npz' %% step),
                         **after)
    result['resnet_losses'] = losses
with open(os.path.join(out_dir, 'rank%%d.json' %% rank), 'w') as f:
    json.dump(result, f)
assert 'jax' not in sys.modules
'''.replace('%%', '%').replace('%(steps)d', str(RESNET_STEPS))


def _jax_bn(case, world, tmp):
    rng = np.random.RandomState(CASES.index(case))
    main, startup, loss, outs, grads = bn_program(jfluid, case)
    feed = _bn_feed(case, rng)
    state = _bn_state(rng)
    np.savez(os.path.join(tmp, 'feed_%s.npz' % case), **feed)
    np.savez(os.path.join(tmp, 'state_%s.npz' % case), **state)
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss.name, places=[jfluid.XLAPlace(i) for i in range(world)])
    names = list(outs.values()) + list(grads.values())
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set_var(n, v.copy())
        got = exe.run(prog, feed=feed, fetch_list=names)
        want = {n: np.asarray(v) for n, v in zip(names, got)}
        want.update(weights.numpy_state(scope, sorted(state)))
    return want, outs, grads


def _jax_sync_bn(tmp):
    from paddle_tpu.fluid.transpiler import GradAllReduce
    rng = np.random.RandomState(7)
    main, startup, loss, outs, grads = bn_program(jfluid, 'NCHW', sync=True)
    GradAllReduce().transpile(startup, main, 0, ENDPOINTS, ENDPOINTS[0])
    main._mesh = Mesh(np.array(jax.devices()[:2]), ('dp',))
    feed = _bn_feed('NCHW', rng)
    state = _bn_state(rng)
    np.savez(os.path.join(tmp, 'feed_sync_NCHW.npz'), **feed)
    np.savez(os.path.join(tmp, 'state_sync_NCHW.npz'), **state)
    names = list(outs.values()) + [grads['X']]
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set_var(n, v.copy())
        got = exe.run(main, feed=feed, fetch_list=names)
        want = {n: np.asarray(v) for n, v in zip(names, got)}
        want.update(weights.numpy_state(scope, sorted(state)))
    return want, outs, grads


def _jax_resnet(tmp):
    """The JAX package's 2 steps over 2 devices; the state before and
    after each step."""
    main, startup, loss = resnet_program(jfluid, jresnet)
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss.name, places=[jfluid.XLAPlace(i) for i in range(2)])
    names = weights.startup_names(resnet_program(tfluid, tresnet)[1])
    rng = np.random.RandomState(0)
    losses, after = [], []
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for step in range(RESNET_STEPS):
            feed = {'image': rng.randn(BATCH, 3, 32, 32).astype('float32'),
                    'label': rng.randint(0, 10, (BATCH, 1)).astype('int64')}
            np.savez(os.path.join(tmp, 'feed%d.npz' % step), **feed)
            np.savez(os.path.join(tmp, 'before%d.npz' % step),
                     **weights.numpy_state(scope, names))
            losses.append(float(np.asarray(
                exe.run(prog, feed=feed, fetch_list=[loss])[0])))
            after.append(weights.numpy_state(scope, names))
    return losses, after, names


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = {}
    for world in WORLDS:
        tmp = str(tmp_path_factory.mktemp('dpbn%d' % world))
        bn = {case: _jax_bn(case, world, tmp) for case in CASES}
        cases = [[c, False] for c in CASES]
        extra = {}
        if world == 2:
            extra['sync'] = _jax_sync_bn(tmp)
            extra['resnet'] = _jax_resnet(tmp)
            cases.append(['NCHW', True])
        with open(os.path.join(tmp, 'cases.json'), 'w') as f:
            json.dump(cases, f)
        ranks = torch_dist_cases.Ranks(tmp, _WORKER, world, args=[tmp],
                                       timeout=200)
        try:
            ranks.wait()
        finally:
            ranks.kill()
        with open(os.path.join(tmp, 'rank0.json')) as f:
            res = json.load(f)
        got = {tag: dict(np.load(os.path.join(tmp, 'got_%s.npz' % tag)))
               for tag in [('sync_' if s else '') + c for c, s in cases]}
        after = [dict(np.load(os.path.join(tmp, 'after%d.npz' % i)))
                 for i in range(RESNET_STEPS)] if world == 2 else None
        out[world] = {'bn': bn, 'got': got, 'res': res, 'after': after,
                      **extra}
    return out


def _grads_close(want, got, names):
    for n in names:
        w, g = want[n].astype(np.float64), got[n].astype(np.float64)
        assert w.shape == g.shape, (n, w.shape, g.shape)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL_OF_MAX, (n, err)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', CASES)
def test_batch_norm_outputs_match_jax(runs, world, case):
    want, outs, _ = runs[world]['bn'][case]
    got = runs[world]['got'][case]
    assert_forward_close({s: [want[n]] for s, n in outs.items()},
                         {s: [got[n]] for s, n in outs.items()})
    # the moving statistics in the scope after the step
    names = [n for n in want if n.endswith(('.w_1', '.w_2'))]
    assert len(names) == 2
    assert_forward_close({n: [want[n]] for n in names},
                         {n: [got[n]] for n in names})


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', CASES)
def test_batch_norm_grads_match_jax(runs, world, case):
    want, _, grads = runs[world]['bn'][case]
    got = runs[world]['got'][case]
    _grads_close(want, got, grads.values())


def test_large_mean_keeps_the_variance(runs):
    """Channel 0 (mean 1e3, std 1): the global SavedVariance against
    float64 over the global batch, on both rank counts."""
    rng = np.random.RandomState(CASES.index('large_mean'))
    x = _bn_feed('large_mean', rng)['x'].astype(np.float64)
    var64 = x.var(axis=(0, 2, 3))
    for world in WORLDS:
        got = runs[world]['got']['large_mean']
        saved = got[runs[world]['bn']['large_mean'][1]['SavedVariance']]
        np.testing.assert_allclose(saved, 1.0 / np.sqrt(var64 + 1e-5),
                                   rtol=1e-4)


def test_sync_batch_norm_matches_jax_run_collective(runs):
    want, outs, grads = runs[2]['sync']
    got = runs[2]['got']['sync_NCHW']
    assert_forward_close({s: [want[n]] for s, n in outs.items()},
                         {s: [got[n]] for s, n in outs.items()})
    names = [n for n in want if n.endswith(('.w_0', '.b_0', '.w_1', '.w_2'))]
    assert len(names) == 4
    assert_forward_close({n: [want[n]] for n in names},
                         {n: [got[n]] for n in names})
    _grads_close(want, got, [grads['X']])


def test_resnet18_lockstep_matches_jax(runs):
    losses, after, names = runs[2]['resnet']
    np.testing.assert_allclose(runs[2]['res']['resnet_losses'], losses,
                               rtol=LOSS_RTOL)
    assert sum('_velocity_' in n for n in names) == 62
    for want, got in zip(after, runs[2]['after']):
        _state_close(want, got, names, 0.01)

"""Mixed precision under data parallel in the port, against the JAX
package, on the CPU.

The fc net of tests/test_torch_data_parallel.py (8 -> 32 -> 16 -> 4,
softmax cross entropy) under decorate(opt, init_loss_scaling 2^10,
decr_every_n_nan_or_inf 1) runs ``with_data_parallel`` on 2 gloo ranks
(rank r fed rows [8 r, 8 r + 8) of each global batch of 16, every rank
from the JAX package's startup values), with SGD under the AllReduce
strategy and with Adam under ``ReduceStrategy.Reduce``; the JAX package
runs the same Program ``with_data_parallel`` over 2 devices of the
conftest's CPU mesh, fed the global batch.  At step 2 rank 1's rows
overflow (x * 1e38: the products overflow to inf, the loss and every
gradient are nan): the executor averages the gradients before
check_finite_and_unscale reads them, so both ranks reach the verdict,
skip SGD's update and halve the scale.

Tolerances: the verdicts, the scale and its counters exact; the ranks'
parameters bitwise equal after every step; the parameters after SGD's
overflowing step bitwise those before it; the losses within rel 1e-2
of the JAX package's (bf16 products on both sides).

The fleet's ``DistributedStrategy.use_amp`` Program serializes as the
JAX package's.
"""

import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

import torch_dist_cases

STEPS = 3
BATCH = 16
WORLD = 2
SCALE_STATE = ('loss_scaling_0', 'good_steps_0', 'bad_steps_0')
CASES = (('sgd', False), ('adam', True))

_NET = '''
def build(fluid, opt, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='int64')
        h = fluid.layers.fc(x, 32, act='relu')
        h2 = fluid.layers.fc(h, 16, act='relu')
        logits = fluid.layers.fc(h2, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        inner = {'sgd': lambda: fluid.optimizer.SGD(0.1),
                 'adam': lambda: fluid.optimizer.Adam(0.01)}[opt]()
        fluid.contrib.mixed_precision.decorate(
            inner, init_loss_scaling=2.0 ** 10,
            decr_every_n_nan_or_inf=1).minimize(loss)
    return main, startup, loss


def strategy(fluid, reduce):
    bs = fluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
    return bs
'''
exec(_NET)


def _batches():
    rng = np.random.RandomState(5)
    out = []
    for i in range(STEPS):
        x = rng.randn(BATCH, 8).astype('float32')
        y = (np.abs(x).sum(1, keepdims=True) * 2).astype('int64') % 4
        if i == 1:
            x[BATCH // 2:] *= np.float32(1e38)  # rank 1's rows
        out.append({'x': x, 'y': y})
    return out


_WORKER = torch_dist_cases.PRELUDE + _NET + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
out_dir = sys.argv[1]
data = np.load(os.path.join(out_dir, 'batches.npz'))
batches = [{'x': data['x%d' % i], 'y': data['y%d' % i]}
           for i in range(len(data.files) // 2)]
rows = len(batches[0]['x']) // world
shard = [{k: v[rank * rows:(rank + 1) * rows] for k, v in b.items()}
         for b in batches]
place = fluid.CPUPlace()
result = {}
for opt, reduce in CASES:
    state = dict(np.load(os.path.join(out_dir, 'state_%s.npz' % opt)))
    main, startup, loss = build(fluid, opt)
    names = sorted(state)
    params = sorted(p.name for p in main.all_parameters())
    exe, scope = fluid.Executor(place), fluid.Scope()
    res = {'losses': [], 'found': [], 'scale': [], 'synced': [],
           'kept': []}
    with fluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, state, place, startup)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=strategy(fluid, reduce))
        for feed in shard:
            before = {n: v.copy() for n, v in
                      weights.numpy_state(scope, params).items()}
            l, f = exe.run(prog, feed=feed, fetch_list=[loss, 'found_inf_0'])
            after = weights.numpy_state(scope, params)
            res['losses'].append(float(l))
            res['found'].append(bool(f))
            res['scale'].append(
                {n: weights.numpy_state(scope, [n])[n].tolist()
                 for n in SCALE_STATE})
            res['kept'].append(all(np.array_equal(before[n], after[n])
                                   for n in params))
            flat = torch.cat([torch.from_numpy(after[n]).reshape(-1)
                              for n in params])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            res['synced'].append(all(torch.equal(e, every[0])
                                     for e in every))
    result[opt] = res
with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
    json.dump(result, f)
assert 'jax' not in sys.modules
'''.replace('CASES', repr(list(CASES))).replace('SCALE_STATE',
                                                repr(SCALE_STATE))


def _jax_train(opt, reduce, state, batches):
    main, startup, loss = build(jfluid, opt)
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=strategy(jfluid, reduce),
        places=[jfluid.XLAPlace(i) for i in range(WORLD)])
    out = {'losses': [], 'found': [], 'scale': []}
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set_var(n, np.array(v))
        for feed in batches:
            l, f = exe.run(prog, feed=feed, fetch_list=[loss, 'found_inf_0'])
            out['losses'].append(float(np.asarray(l)))
            out['found'].append(bool(np.asarray(f)))
            out['scale'].append({n: np.asarray(scope.find_var(n)).tolist()
                                 for n in SCALE_STATE})
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    batches = _batches()
    tmp = str(tmp_path_factory.mktemp('amp_dp'))
    np.savez(os.path.join(tmp, 'batches.npz'),
             **{'%s%d' % (k, i): b[k] for i, b in enumerate(batches)
                for k in b})
    states = {}
    for opt, _ in CASES:
        names = weights.startup_names(build(tfluid, opt)[1])
        js = build(jfluid, opt)[1]
        sc = jfluid.Scope()
        with jfluid.scope_guard(sc):
            jfluid.Executor(jfluid.XLAPlace(0)).run(js)
            states[opt] = weights.numpy_state(sc, names)
        np.savez(os.path.join(tmp, 'state_%s.npz' % opt), **states[opt])
    ranks = torch_dist_cases.Ranks(tmp, _WORKER, WORLD, args=[tmp],
                                   timeout=150)
    try:
        jax_runs = {opt: _jax_train(opt, reduce, states[opt], batches)
                    for opt, reduce in CASES}
        ranks.wait()
    finally:
        ranks.kill()
    port = []
    for r in range(WORLD):
        with open(os.path.join(tmp, 'rank%d.json' % r)) as f:
            port.append(json.load(f))
    return {'jax': jax_runs, 'port': port}


@pytest.mark.parametrize('opt', [c[0] for c in CASES])
def test_every_rank_takes_the_overflow_verdict(runs, opt):
    want = runs['jax'][opt]
    assert want['found'] == [False, True, False]
    for res in runs['port']:
        got = res[opt]
        assert got['found'] == want['found']
        assert got['scale'] == want['scale']
        assert [s['loss_scaling_0'] for s in got['scale']] == \
            [[1024.0], [512.0], [512.0]]
        assert all(got['synced'])
        np.testing.assert_allclose(got['losses'], want['losses'], rtol=1e-2)


def test_sgd_skips_the_overflowing_step_on_every_rank(runs):
    for res in runs['port']:
        assert res['sgd']['kept'] == [False, True, False]
    # Adam moves its parameters on zero gradients (its moments decay)
    for res in runs['port']:
        assert res['adam']['kept'] == [False, False, False]


def test_fleet_use_amp_program_serializes_like_jax(monkeypatch):
    """CollectiveOptimizer with use_amp: decorate at amp_loss_scaling
    around the all-reduces, the same Program as the JAX package's (its
    rank count is the CPU mesh's 8 devices; the port's is the launcher's
    world size, set to 8 here)."""
    from paddle_tpu.fluid.incubate.fleet.collective import \
        CollectiveOptimizer as JCO, DistributedStrategy as JDS
    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.fluid.incubate.fleet.collective import \
        CollectiveOptimizer as TCO, DistributedStrategy as TDS
    from test_torch_amp_decorate import _assert_same_block
    monkeypatch.setattr(launch, 'world_size', lambda: 8)
    progs = []
    for fluid, co, ds in ((jfluid, JCO, JDS), (tfluid, TCO, TDS)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[8], dtype='float32')
            y = fluid.layers.data('y', shape=[1], dtype='int64')
            logits = fluid.layers.fc(fluid.layers.fc(x, 16, act='relu'), 4)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, y))
            s = ds()
            s.use_amp = True
            s.amp_loss_scaling = 2.0 ** 12
            co(fluid.optimizer.Adam(0.01), s).minimize(loss)
        progs.append((main, startup))
    for jp, tp in zip(*progs):
        (jb,), (tb,) = jp.to_dict()['blocks'], tp.to_dict()['blocks']
        _assert_same_block(jb, tb)
    types = [op.type for op in progs[1][0].global_block().ops]
    assert types.count('c_allreduce_sum') == 4
    fill = [op for op in progs[1][1].global_block().ops
            if op.output('Out') == ['loss_scaling_0']]
    assert fill[0].attrs['value'] == 2.0 ** 12

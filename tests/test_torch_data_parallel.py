"""The port's ``CompiledProgram.with_data_parallel`` and
``ParallelExecutor`` against the JAX package's, on the CPU.

The model is tests/test_data_parallel.py's fc net (8 -> 32 -> 16 -> 4,
softmax cross entropy, mean) with SGD 0.1, Adam 0.01 and Momentum 0.1 /
0.9, 4 steps on global batches of 16 rows:

- in the JAX package, ``with_data_parallel`` over 2 and 4 devices of the
  conftest's 8-device CPU mesh (``places``), fed the global batch;
- in the port, on 2 and 4 gloo ranks started by its launcher, rank r fed
  rows [r * 16 / n, (r + 1) * 16 / n) and starting from the JAX
  package's startup values.

Tolerances, and why: the losses to rtol 1e-5 (the single-card parity
tests' bound: both sides compute in f32, the port's gradient summed over
the ranks in gloo's order and divided by their number, XLA's over the
global batch in its own); the parameters and accumulators after 4
steps to atol 2e-6 (values up to ~1; 4 steps move them by at most
~0.4, and the two orders differ by a few f32 roundings a step).
``ReduceStrategy.Reduce`` is held bitwise to the AllReduce strategy in
the port and at the same tolerances to the JAX package's Reduce.
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

STEPS = 4
BATCH = 16
WORLDS = (2, 4)
OPTS = ('sgd', 'adam', 'momentum')
ENDPOINTS = ['127.0.0.1:%d' % (6170 + i) for i in range(8)]

# the fc net of tests/test_data_parallel.py, in either package
_NET = '''
def build(fluid, opt, seed=3, transpile=None):
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
        test = main.clone(for_test=True)
        {'sgd': lambda: fluid.optimizer.SGD(0.1),
         'adam': lambda: fluid.optimizer.Adam(0.01),
         'momentum': lambda: fluid.optimizer.Momentum(0.1, momentum=0.9)
         }[opt]().minimize(loss)
    if transpile is not None:
        transpile(startup, main)
    return main, startup, loss, logits, test


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
    for _ in range(STEPS):
        x = rng.randn(BATCH, 8).astype('float32')
        y = (np.abs(x).sum(1, keepdims=True) * 2).astype('int64') % 4
        out.append({'x': x, 'y': y})
    return out


# (optimizer, Reduce?, transpiled?) cases both packages run
CASES = [(o, False, False) for o in OPTS] + \
    [('adam', True, False), ('momentum', True, False),
     ('sgd', False, True)]


def _key(case):
    return '%s%s%s' % (case[0], '_reduce' if case[1] else '',
                       '_transpiled' if case[2] else '')


_WORKER = torch_dist_cases.PRELUDE + _NET + \
    'ENDPOINTS = %r\n' % ENDPOINTS + r'''
import json
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid.transpiler import GradAllReduce
out_dir = sys.argv[1]
cases = json.load(open(os.path.join(out_dir, 'cases.json')))
state = dict(np.load(os.path.join(out_dir, 'state.npz')))
data = np.load(os.path.join(out_dir, 'batches.npz'))
batches = [{'x': data['x%d' % i], 'y': data['y%d' % i]}
           for i in range(len(data.files) // 2)]
rows = len(batches[0]['x']) // world
shard = [{k: v[rank * rows:(rank + 1) * rows] for k, v in b.items()}
         for b in batches]
place = fluid.CPUPlace()
result = {}


def transpiler(startup, main):
    GradAllReduce().transpile(startup, main, rank, ENDPOINTS,
                              ENDPOINTS[rank])


def synced(scope, names):
    flat = torch.cat([scope.find_var(n).reshape(-1) for n in names])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    return all(torch.equal(e, every[0]) for e in every)


def train(case, runner='compiled'):
    opt, reduce, transpiled = case
    main, startup, loss, logits, test = build(
        fluid, opt, transpile=transpiler if transpiled else None)
    exe, scope = fluid.Executor(place), fluid.Scope()
    names = sorted(state)
    params = sorted(p.name for p in main.all_parameters())
    res = {'losses': [], 'synced': []}
    with fluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, state, place, startup)
        if runner == 'compiled':
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=strategy(fluid, reduce))
            run = lambda feed, fetch: exe.run(prog, feed=feed,
                                              fetch_list=fetch)
        else:
            pe = fluid.ParallelExecutor(
                use_cuda=False, loss_name=loss.name, main_program=main,
                build_strategy=strategy(fluid, reduce))
            run = lambda feed, fetch: pe.run(fetch, feed=feed)
        for i, feed in enumerate(shard):
            l, lg = run(feed, [loss, logits])
            res['losses'].append(float(l))
            if i == 0:
                res['logits'] = lg.tolist()
            res['synced'].append(synced(scope, params))
        res['rows'] = {n: list(scope.find_var(n).shape) for n in names}
        final = weights.numpy_state(scope, names)
        if runner != 'compiled':
            tpe = fluid.ParallelExecutor(
                use_cuda=False, loss_name=loss.name, main_program=test,
                share_vars_from=pe)
            tl, tlg = tpe.run([loss.name, logits.name], feed=shard[0])
            res['eval'] = [float(tl), tlg.tolist()]
        if reduce:
            d = os.path.join(out_dir, 'saved_%d' % rank)
            fluid.io.save_persistables(exe, d, main)
            with np.load(os.path.join(d, '__model_params__.npz')) as f:
                res['saved_whole'] = all(
                    np.array_equal(f[n], final[n]) for n in f.files)
    return res, final


for case in cases:
    key = '%s%s%s' % (case[0], '_reduce' if case[1] else '',
                          '_transpiled' if case[2] else '')
    res, final = train(tuple(case))
    result[key] = res
    if rank == 0:
        np.savez(os.path.join(out_dir, 'final_%s.npz' % key), **final)
    if case[1]:
        plain = dict(np.load(os.path.join(out_dir, 'final_%s.npz'
                                          % case[0]))) if rank == 0 else {}
        res['bitwise_allreduce'] = rank != 0 or all(
            np.array_equal(final[n], plain[n]) for n in final)
res_pe, _ = train(('momentum', False, False), runner='pe')
result['pe'] = res_pe

# unequal local batches: every rank raises, naming the feed
main, startup, loss, logits, test = build(fluid, 'sgd')
exe, scope = fluid.Executor(place), fluid.Scope()
with fluid.scope_guard(scope):
    exe.run(startup)
    prog = fluid.CompiledProgram(main).with_data_parallel(loss.name)
    feed = {k: v[:rows - (rank == 1)] for k, v in shard[0].items()}
    try:
        exe.run(prog, feed=feed, fetch_list=[loss])
        result['unequal'] = None
    except ValueError as e:
        result['unequal'] = str(e)
with open(os.path.join(out_dir, 'rank%d.json' % rank), 'w') as f:
    json.dump(result, f)
assert 'jax' not in sys.modules
'''


def _jax_train(state, batches, case, world):
    opt, reduce, transpiled = case

    def transpile(startup, main):
        from paddle_tpu.fluid.transpiler import GradAllReduce
        GradAllReduce().transpile(startup, main, 0, ENDPOINTS, ENDPOINTS[0])

    main, startup, loss, logits, test = build(
        jfluid, opt, transpile=transpile if transpiled else None)
    exe, scope = jfluid.Executor(jfluid.XLAPlace(0)), jfluid.Scope()
    prog = jfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=strategy(jfluid, reduce),
        places=[jfluid.XLAPlace(i) for i in range(world)])
    losses = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, v in state.items():
            scope.set_var(n, np.array(v))
        for i, feed in enumerate(batches):
            l, lg = exe.run(prog, feed=feed, fetch_list=[loss, logits])
            losses.append(float(np.asarray(l)))
            if i == 0:
                first_logits = np.asarray(lg)
        final = weights.numpy_state(scope, sorted(state))
        tprog = jfluid.CompiledProgram(test).with_data_parallel(
            places=[jfluid.XLAPlace(i) for i in range(world)])
        tl, tlg = exe.run(tprog, feed=batches[0],
                          fetch_list=[loss.name, logits.name])
    return {'losses': losses, 'final': final, 'logits': first_logits,
            'eval': [float(np.asarray(tl)), np.asarray(tlg)]}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    batches = _batches()
    _, startup, _, _, _ = build(jfluid, 'sgd')
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.XLAPlace(0)).run(startup)
    state = {}
    port = {}
    ranks = []
    try:
        for opt in OPTS:
            # the optimizers' own state (moments, beta powers, lr)
            s = build(tfluid, opt)[1]
            names = weights.startup_names(s)
            jm, js, _, _, _ = build(jfluid, opt)
            sc = jfluid.Scope()
            with jfluid.scope_guard(sc):
                jfluid.Executor(jfluid.XLAPlace(0)).run(js)
                state[opt] = weights.numpy_state(sc, names)
        # the ranks read one state with every optimizer's names
        merged = {}
        for opt in OPTS:
            merged.update(state[opt])
        tmps = {}
        for world in WORLDS:
            tmp = str(tmp_path_factory.mktemp('dp%d' % world))
            tmps[world] = tmp
            np.savez(os.path.join(tmp, 'state.npz'), **merged)
            np.savez(os.path.join(tmp, 'batches.npz'),
                     **{'%s%d' % (k, i): b[k] for i, b in enumerate(batches)
                        for k in b})
            with open(os.path.join(tmp, 'cases.json'), 'w') as f:
                json.dump(CASES, f)
            ranks.append(torch_dist_cases.Ranks(tmp, _WORKER, world,
                                                args=[tmp], timeout=200))
        jax_runs = {(w, _key(c)): _jax_train(merged, batches, c, w)
                    for w in WORLDS for c in CASES}
        for r in ranks:
            r.wait()
    finally:
        for r in ranks:
            r.kill()
    for world, tmp in tmps.items():
        per_rank = []
        for r in range(world):
            with open(os.path.join(tmp, 'rank%d.json' % r)) as f:
                per_rank.append(json.load(f))
        finals = {_key(c): dict(np.load(os.path.join(
            tmp, 'final_%s.npz' % _key(c)))) for c in CASES}
        port[world] = {'ranks': per_rank, 'final': finals}
    return {'jax': jax_runs, 'port': port, 'batches': batches}


def _close(got, want, names):
    for n in names:
        np.testing.assert_allclose(got[n], want[n], atol=2e-6, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('opt', OPTS)
def test_matches_jax(runs, world, opt):
    port, jax_run = runs['port'][world], runs['jax'][(world, opt)]
    np.testing.assert_allclose(port['ranks'][0][opt]['losses'],
                               jax_run['losses'], rtol=1e-5)
    _close(port['final'][opt], jax_run['final'], jax_run['final'])


@pytest.mark.parametrize('opt', ('adam', 'momentum'))
def test_reduce_bitwise_allreduce(runs, opt):
    """Reduce's parameters and accumulators are bitwise the AllReduce
    strategy's in the port, and match the JAX package's Reduce."""
    key = opt + '_reduce'
    for world in WORLDS:
        port = runs['port'][world]
        assert port['ranks'][0][key]['bitwise_allreduce'] is True
        assert port['ranks'][0][key]['losses'] == \
            port['ranks'][0][opt]['losses']
        jax_run = runs['jax'][(world, key)]
        np.testing.assert_allclose(port['ranks'][0][key]['losses'],
                                   jax_run['losses'], rtol=1e-5)
        _close(port['final'][key], jax_run['final'], jax_run['final'])


def test_reduce_keeps_each_rank_its_rows(runs):
    """Under Reduce each accumulator whose dim 0 is > 1 and divisible by
    the ranks holds 1 / n of its rows on each rank; the beta powers,
    the learning rate and the parameters stay whole; the saved
    accumulators are whole."""
    for world in WORLDS:
        for key, acc, count in (('adam_reduce', '_moment', 12),
                                ('momentum_reduce', '_velocity_0', 6)):
            whole = runs['port'][world]['ranks'][0]['sgd']['rows']
            for res in runs['port'][world]['ranks']:
                rows = res[key]['rows']
                sharded = [n for n in rows if acc in n]
                assert len(sharded) == count
                for n in sharded:
                    full = runs['port'][world]['final'][key][n].shape
                    if full[0] % world == 0 and full[0] > 1:
                        assert rows[n] == [full[0] // world] + list(
                            full[1:]), n
                    else:
                        assert rows[n] == list(full), n
                for n in whole:
                    if n not in sharded:
                        assert rows[n] == whole[n], n
                assert res[key]['saved_whole'] is True


def test_ranks_stay_bitwise_in_sync(runs):
    for world in WORLDS:
        for res in runs['port'][world]['ranks']:
            for c in CASES:
                assert res[_key(c)]['synced'] == [True] * STEPS
            assert res['pe']['synced'] == [True] * STEPS


def test_gathered_fetch_is_the_global_array(runs):
    """The per-example logits fetched at step 1 are the global batch's
    in rank order, as the JAX package fetches them."""
    for world in WORLDS:
        for res in runs['port'][world]['ranks']:
            got = np.asarray(res['sgd']['logits'], np.float32)
            assert got.shape == (BATCH, 4)
            np.testing.assert_allclose(
                got, runs['jax'][(world, 'sgd')]['logits'], atol=1e-6)


def test_transpiled_program_is_not_reduced_twice(runs):
    """A GradAllReduce-transpiled program under with_data_parallel: the
    c_allreduce ops are the identity (the JAX package lowers them so
    outside shard_map) and its 1/nranks scales stay, in both packages."""
    for world in WORLDS:
        port = runs['port'][world]
        jax_run = runs['jax'][(world, 'sgd_transpiled')]
        np.testing.assert_allclose(
            port['ranks'][0]['sgd_transpiled']['losses'],
            jax_run['losses'], rtol=1e-5)
        _close(port['final']['sgd_transpiled'], jax_run['final'],
               jax_run['final'])
        # the scales make the update 1/8 of the untranspiled one
        assert not np.allclose(port['final']['sgd_transpiled']['fc_0.w_0'],
                               port['final']['sgd']['fc_0.w_0'])


def test_parallel_executor_and_shared_test_clone(runs):
    """ParallelExecutor(use_cuda=False) trains as the CompiledProgram
    does, and a clone(for_test=True) sharing its variables evaluates
    the global batch: its loss averaged, its logits gathered, as the
    JAX package's data-parallel test clone gives them."""
    for world in WORLDS:
        res = runs['port'][world]['ranks']
        assert res[0]['pe']['losses'] == res[0]['momentum']['losses']
        loss, logits = res[0]['pe']['eval']
        for r in res:
            assert r['pe']['eval'] == res[0]['pe']['eval']
        want_loss, want_logits = runs['jax'][(world, 'momentum')]['eval']
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(logits, np.float32),
                                   want_logits, atol=1e-5)


def test_unequal_local_batches_raise(runs):
    for world in WORLDS:
        for res in runs['port'][world]['ranks']:
            assert res['unequal'] is not None
            assert "feed 'x'" in res['unequal'] or \
                "feed 'y'" in res['unequal']


def test_world_size_one_is_executor_run():
    """A process with no group runs one replica: bitwise Executor.run,
    Reduce included."""
    batches = _batches()
    out = []
    for compiled in (False, True):
        main, startup, loss, _, _ = build(tfluid, 'adam')
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss.name, build_strategy=strategy(tfluid, True)) \
            if compiled else main
        with tfluid.scope_guard(scope):
            exe.run(startup)
            losses = [exe.run(prog, feed=b, fetch_list=[loss])[0]
                      for b in batches]
            out.append((losses, weights.numpy_state(
                scope, weights.startup_names(startup))))
    for a, b in zip(out[0][0], out[1][0]):
        assert np.array_equal(a, b)
    for n in out[0][1]:
        assert np.array_equal(out[0][1][n], out[1][1][n]), n


def test_with_data_parallel_keeps_the_program():
    """with_data_parallel adds no op: to_dict() is unchanged, and equal
    to the JAX package's."""
    main = build(tfluid, 'momentum')[0]
    before = json.dumps(main.to_dict(), sort_keys=True)
    tfluid.CompiledProgram(main).with_data_parallel(
        build_strategy=strategy(tfluid, True))
    assert json.dumps(main.to_dict(), sort_keys=True) == before
    jmain = build(jfluid, 'momentum')[0]
    jfluid.CompiledProgram(jmain).with_data_parallel()
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]


def _scale_one():
    bs = tfluid.BuildStrategy()
    bs.gradient_scale_strategy = \
        tfluid.BuildStrategy.GradientScaleStrategy.One
    tfluid.CompiledProgram(build(tfluid, 'sgd')[0]).with_data_parallel(
        build_strategy=bs)


@pytest.mark.parametrize('call,error,words', [
    (_scale_one, ValueError, 'CoeffNumDevice'),
    (lambda: tfluid.CompiledProgram(build(tfluid, 'sgd')[0]).with_mesh(
        None), NotImplementedError, 'item 13'),
    (lambda: tfluid.CompiledProgram(build(tfluid, 'sgd')[0])
     .with_param_shardings({}), NotImplementedError, 'item 13'),
    (lambda: tfluid.CompiledProgram(build(tfluid, 'sgd')[0])
     .with_data_parallel(places=tfluid.cpu_places() * 2),
     NotImplementedError, 'paddle_tpu_torch.distributed.launch'),
], ids=['gradient_scale_one', 'with_mesh', 'with_param_shardings',
        'places_without_group'])
def test_refused(call, error, words):
    with pytest.raises(error, match=words):
        call()

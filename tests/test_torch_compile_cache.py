"""The port's fluid/compile_cache.py and Executor.warmup / compile on
the CPU, against the JAX package's compile_cache where both have one.

- The op-content digest (``_hash_ops``) of a Program moved from the JAX
  package with ``to_dict`` / ``from_dict`` is bitwise the JAX
  package's digest of the Program it came from: tiny BERT pretraining
  with Adam, the same under AMP ``decorate``, ResNet-50 at 32 x 32 with
  Momentum and the tiny Transformer with Adam.  The op walk, the type
  tags and the volatile attrs are the JAX package's.
- ``fingerprint``: content-identical programs (built twice) share one;
  a changed attribute, feed shape or dtype, or flag item does not.
- a plan's CUDA graphs are keyed by the feed signature and the
  switches read at Python time, and kept weakly per scope; the plane
  counts the live graphs; ``FLAGS_plan_cache_capacity`` 0 is unbounded.
- ``LRUCache``: the same inserts and reads leave the same keys, in the
  same order, and count the same evictions as the JAX package's.
- ``Executor.warmup`` on ``CPUPlace`` builds the plan, captures nothing,
  and names each signature it skipped with its reason.
- ``Executor.compile`` returns a CompiledStep whose outputs equal
  ``Executor.run``'s bitwise, and raises on bad names and host ops.
"""

import hashlib

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import compile_cache as jcc
from paddle_tpu.fluid import monitor as jmonitor
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtr

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import compile_cache as tcc
from paddle_tpu_torch.fluid import cuda_graph
from paddle_tpu_torch.ops.kernels import common


def _digest(mod, program):
    h = hashlib.sha256()
    mod._hash_ops(h, program.global_block().ops, set())
    return h.hexdigest()


def _jax_program(kind):
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 3
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        if kind in ('bert', 'amp_bert'):
            _, _, loss = jbert.build_pretrain(jbert.TINY, seq_len=32)
            opt = jfluid.optimizer.Adam(1e-3)
            if kind == 'amp_bert':
                opt = jfluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(loss)
        elif kind == 'resnet':
            _, _, loss, _ = jresnet.build((3, 32, 32), 10, 50)
            jfluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        else:
            _, _, loss = jtr.build(jtr.TINY, 16, 16)
            jfluid.optimizer.Adam(1e-3).minimize(loss)
    return main


@pytest.mark.parametrize('kind', ['bert', 'amp_bert', 'resnet',
                                  'transformer'])
def test_op_digest_is_the_jax_packages(kind):
    jprog = _jax_program(kind)
    tprog = tfluid.Program.from_dict(jprog.to_dict())
    assert len(tprog.global_block().ops) > 100
    assert _digest(tcc, tprog) == _digest(jcc, jprog)


def _fc(seed=3, size=8, act='relu'):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[6], dtype='float32')
        y = tfluid.layers.fc(tfluid.layers.fc(x, size, act=act), 3)
    return main, startup, y


def test_fingerprint_shares_content_and_tells_changes_apart():
    feed = {'x': np.zeros((2, 6), 'float32')}
    specs = tcc.arg_specs(feed)
    flags = (('FLAGS_torch_kernels_plain', False),)

    def fp(main, specs=specs, flags=flags):
        return tcc.fingerprint(main.global_block().ops, specs, flags,
                               purpose='graph')

    a, b = _fc()[0], _fc()[0]
    assert a is not b and fp(a) == fp(b)
    # numpy and torch feeds of one shape and dtype: one signature
    assert tcc.arg_specs({'x': torch.zeros(2, 6)}) == specs
    assert fp(_fc(act='tanh')[0]) != fp(a)
    c = _fc()[0]
    mul = c.global_block().ops[0]
    assert mul.type == 'mul' and mul.attrs['x_num_col_dims'] == 1
    mul.attrs['x_num_col_dims'] = 2
    assert fp(c) != fp(a)
    assert fp(a, tcc.arg_specs({'x': np.zeros((4, 6), 'float32')})) != fp(a)
    assert fp(a, tcc.arg_specs({'x': np.zeros((2, 6), 'float64')})) != fp(a)
    assert fp(a, flags=(('FLAGS_torch_kernels_plain', True),)) != fp(a)
    # creation-site stacks are volatile: they do not change it
    for op in b.global_block().ops:
        op.attrs['__op_callstack__'] = ['elsewhere']
    assert fp(b) == fp(a)


def test_graph_signature_covers_feeds_and_switches():
    """A plan's graphs are keyed by the feeds' names, shapes and dtypes
    and the switches read at Python time (the plain flag, TF32), and
    kept per scope, weakly: a dead scope's graphs go with it."""
    import gc
    feed = {'x': np.zeros((2, 6), 'float32')}
    sig = cuda_graph._signature(feed)
    assert cuda_graph._signature({'x': torch.zeros(2, 6)}) == sig
    assert cuda_graph._signature({'x': np.zeros((4, 6), 'float32')}) != sig
    assert cuda_graph._signature({'x': np.zeros((2, 6), 'float64')}) != sig
    assert cuda_graph._signature({'y': np.zeros((2, 6), 'float32')}) != sig
    saved = tfluid.get_flags('FLAGS_torch_kernels_plain')
    try:
        tfluid.set_flags({'FLAGS_torch_kernels_plain': True})
        assert cuda_graph._signature(feed) != sig
    finally:
        tfluid.set_flags(saved)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        assert cuda_graph._signature(feed) != sig
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    main, _, y = _fc()
    plan = tfluid.Executor(tfluid.CPUPlace())._get_plan(main, feed, [y.name])
    scopes = [tfluid.Scope(), tfluid.Scope()]
    graphs = [cuda_graph._graphs(plan, s) for s in scopes]
    assert graphs[0] is not graphs[1]
    assert cuda_graph._graphs(plan, scopes[0]) is graphs[0]
    del scopes[0]
    gc.collect()
    assert list(plan.graphs.keys()) == scopes


def test_env_key_covers_every_kernel_library():
    key = tcc._env_key()
    libs = key[-1]
    sources = {k['source'] for k in common.KERNELS.values()}
    assert len(libs) == len(sources) and len(sources) >= 8
    assert key[1] == torch.__version__


def test_lru_matches_jax():
    ops = [('set', k) for k in 'abcd'] + [('get', 'a'), ('set', 'e'),
                                          ('get', 'c'), ('set', 'f'),
                                          ('set', 'a'), ('get', 'b'),
                                          ('set', 'g')]
    runs = {}
    for name, mod, value in (
            ('jax', jcc, lambda: jmonitor.counter_value('t/evict')),
            ('torch', tcc, lambda: tcc.counter_value('t/evict'))):
        cache = mod.LRUCache(3, 't/evict')
        before = value()
        seen = []
        for op, k in ops:
            if op == 'set':
                cache[k] = k.upper()
            else:
                seen.append(cache.get(k))
        runs[name] = (cache.keys(), seen, value() - before)
    assert runs['torch'] == runs['jax']
    assert runs['torch'][2] == 5
    unbounded = tcc.LRUCache(0)
    for i in range(100):
        unbounded[i] = i
    assert len(unbounded) == 100


def test_plane_counts_live_graphs():
    """The plane sees each graph captured since it started, while the
    graph lives (its plan owns it), and reads the counters."""
    import gc

    class Graph(object):
        pass

    tcc.reset_plane()
    try:
        plane = tcc.plane()
        graphs = [Graph(), Graph()]
        for g in graphs:
            plane.register(g)
        assert plane.entry_count() == 2
        del graphs[0]
        gc.collect()
        stats = plane.stats()
        assert stats['memory_entries'] == 1
        assert {'plan_cache_hit', 'plan_cache_miss', 'graph_captures',
                'graph_replays', 'graph_refused'} <= set(stats)
        tcc.count('executor/graph_refused')
        assert plane.stats()['graph_refused'] == stats['graph_refused'] + 1
    finally:
        tcc.reset_plane()


def test_plan_cache_capacity_zero_is_unbounded():
    """FLAGS_plan_cache_capacity 0 keeps every plan, as in the JAX
    package, and a capacity set later reaches a Program built before."""
    main, startup, y = _fc()
    exe = tfluid.Executor(tfluid.CPUPlace())
    saved = tfluid.get_flags('FLAGS_plan_cache_capacity')
    try:
        tfluid.set_flags({'FLAGS_plan_cache_capacity': 0})
        for i in range(70):
            exe._get_plan(main, {'x%d' % i: None}, [y.name])
        assert len(main._exec_cache) == 70
        tfluid.set_flags({'FLAGS_plan_cache_capacity': 3})
        exe._get_plan(main, {}, [y.name])
        assert len(main._exec_cache) == 3
    finally:
        tfluid.set_flags(saved)


def test_warmup_on_cpu_plans_and_skips_every_signature():
    main, startup, y = _fc()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        res = exe.warmup(main, [{'x': ((1, 6), 'float32')},
                                {'x': np.zeros((4, 6), 'float32')}],
                         fetch_list=[y])
        assert res.captured == []
        assert [row for row, _ in res.skipped] == [
            (('x', (1, 6), 'float32'),), (('x', (4, 6), 'float32'),)]
        assert all('CUDA graphs need a CUDA place' in why
                   for _, why in res.skipped)
        assert len(main._exec_cache) == 1
        hits = tcc.counter_value('executor/plan_cache_hit')
        exe.run(main, feed={'x': np.ones((4, 6), 'float32')},
                fetch_list=[y])
        assert tcc.counter_value('executor/plan_cache_hit') == hits + 1


def test_warmup_names_a_training_program():
    """A training step may be captured, its batch norm's running
    statistics included (only the CPU place keeps it eager here); a
    startup program is named as never captured: its initializers draw
    from a host generator."""
    main, startup, y = _fc()
    with tfluid.program_guard(main, startup):
        z = tfluid.layers.batch_norm(tfluid.layers.reshape(y, [-1, 3, 1, 1]))
        tfluid.optimizer.SGD(0.1).minimize(tfluid.layers.mean(z))
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        res = exe.warmup(main, {'x': ((2, 6), 'float32')}, [y])
        (_, why), = res.skipped
        assert 'CUDA graphs need a CUDA place' in why
        (plan,) = main._exec_cache.values()
        assert plan.kind == 'wpg' and plan.no_graph is None
        res = exe.warmup(startup, {}, [])
    (_, why), = res.skipped
    assert 'host generator' in why and 'uniform_random' in why


def test_compiled_step_is_run_bitwise():
    main, startup, y = _fc()
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.random.RandomState(0).randn(3, 6).astype('float32')
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        want = exe.run(main, feed={'x': x}, fetch_list=[y])[0]
        step = exe.compile(main, feed_names=['x'], fetch_names=[y])
        scope = tfluid.global_scope()
        assert 'x' in step.input_names and step.state_names == []
        data = {n: scope.find_var(n) for n in step.input_names if n != 'x'}
        data['x'] = x
        got = step(5, {}, data)
        assert list(got) == [y.name]
        assert np.array_equal(got[y.name].numpy(), want)
        with pytest.raises(ValueError, match='not read by the program'):
            exe.compile(main, feed_names=['nope'], fetch_names=[y])
        with pytest.raises(ValueError, match='not produced'):
            exe.compile(main, feed_names=['x'], fetch_names=['x'])


def test_compiled_step_of_a_training_program_leaves_state_alone():
    main, startup, y = _fc()
    with tfluid.program_guard(main, startup):
        loss = tfluid.layers.mean(y)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.ones((2, 6), 'float32')
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        scope = tfluid.global_scope()
        step = exe.compile(main, feed_names=['x'], fetch_names=[loss])
        params = [p.name for p in main.all_parameters()]
        assert sorted(step.state_names) == sorted(params)
        state = {n: scope.find_var(n) for n in step.state_names}
        before = {n: v.clone() for n, v in state.items()}
        data = {n: scope.find_var(n) for n in step.input_names if n != 'x'}
        data['x'] = x
        out = step(1, state, data)
        assert all(torch.equal(state[n], before[n]) for n in state)
        exe._step = 0
        want = exe.run(main, feed={'x': x}, fetch_list=[loss])[0]
        assert np.array_equal(out[loss.name].numpy(), want)
        assert all(torch.equal(out[n], scope.find_var(n)) for n in params)


def test_compile_with_host_ops_names_item_7():
    main, startup, y = _fc()
    main.global_block().append_op('print', inputs={'In': y},
                                  outputs={'Out': y}, infer_shape=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    # allow_host=True compiles the pipeline around the host op
    pipe = exe.compile(main, ['x'], [y], allow_host=True)
    assert pipe.host_op_types == ['print']
    with pytest.raises(ValueError, match='host ops'):
        exe.compile(main, ['x'], [y])

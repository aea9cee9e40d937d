"""The port's run-plan cache (``Executor._get_plan``, a Program's
``_exec_cache``) and its argument binder, on the CPU.

- A cached run is bitwise the uncached run (``use_program_cache=False``
  builds the plan anew each call): 3 training steps from one state of
  tiny BERT with Adam (the fused attention op, attention dropout 0.1),
  tiny BERT under ``decorate(Adam)`` (AMP, bf16 on the CPU), Wide&Deep
  with sparse Adagrad, LeNet-5 with Adam and the Transformer with
  Adam, and a 2-rank ``with_data_parallel`` run over gloo.  Bitwise,
  because both run the same lowerings in the same order on the same
  values; the losses and every variable of the startup program after
  the steps are compared.
- The plan cache's hits and misses over one sequence of runs (a
  repeat, another fetch list, a ``clone(for_test=True)``, a rewrite
  that bumps the version, ``use_program_cache=False``) equal the JAX
  package's ``executor/plan_cache_hit`` / ``plan_cache_miss`` deltas
  over the same sequence.
- Every rewrite of a Program in the port bumps its version, which
  empties its plan cache.
"""

import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import monitor as jmonitor

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import compile_cache, io as tio
from paddle_tpu_torch.fluid.contrib.mixed_precision import decorator
from paddle_tpu_torch.models import bert, lenet, transformer, wide_deep

import torch_dist_cases

STEPS = 3


def _bert_cfg():
    cfg = bert.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                          intermediate=128, max_pos=64, dropout=0.0,
                          attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _model(name):
    """(main, startup, loss, batches) of one tiny training path."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    rng = np.random.RandomState(3)
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        if name in ('bert_adam', 'amp_bert'):
            cfg = _bert_cfg()
            _, _, loss = bert.build_pretrain(cfg, seq_len=32)
            opt = tfluid.optimizer.Adam(1e-3, epsilon=1e-6)
            if name == 'amp_bert':
                opt = tfluid.contrib.mixed_precision.decorate(
                    opt, init_loss_scaling=2.0 ** 10)
            opt.minimize(loss)
            batches = [bert.synthetic_batch(cfg, 2, 32, rng)
                       for _ in range(STEPS)]
        elif name == 'wide_deep':
            _, _, loss = wide_deep.build(wide_deep.TINY)
            tfluid.optimizer.Adagrad(0.05, epsilon=1e-6).minimize(loss)
            batches = [wide_deep.synthetic_batch(wide_deep.TINY, 8, rng)
                       for _ in range(STEPS)]
        elif name == 'lenet':
            _, _, loss, _ = lenet.build()
            tfluid.optimizer.Adam(1e-3).minimize(loss)
            batches = [{'img': rng.rand(4, 1, 28, 28).astype('float32'),
                        'label': rng.randint(0, 10, (4, 1)).astype('int64')}
                       for _ in range(STEPS)]
        else:
            cfg = transformer.TransformerConfig(
                src_vocab=200, tgt_vocab=200, d_model=32, heads=4, ffn=64,
                enc_layers=1, dec_layers=1, dropout=0.1, max_len=16)
            _, _, loss = transformer.build(cfg, src_len=16, tgt_len=16)
            tfluid.optimizer.Adam(1e-3).minimize(loss)
            batches = [transformer.synthetic_batch(cfg, 4, 16, 16, rng)
                       for _ in range(STEPS)]
    return main, startup, loss, batches


def _steps(exe, main, loss, batches, start, step0, cache):
    """STEPS steps from `start` at executor step step0: (losses, state
    after) as numpy."""
    scope = tfluid.global_scope()
    for n, v in start.items():
        scope.set_var(n, v.clone())
    exe._step = step0
    losses = [exe.run(main, feed=b, fetch_list=[loss],
                      use_program_cache=cache)[0] for b in batches]
    return losses, {n: scope.find_var(n).detach().clone() for n in start}


@pytest.mark.parametrize('name', ['bert_adam', 'amp_bert', 'wide_deep',
                                  'lenet', 'transformer'])
def test_cached_run_is_bitwise_uncached(name):
    main, startup, loss, batches = _model(name)
    names = weights.startup_names(startup)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        scope = tfluid.global_scope()
        start = {n: scope.find_var(n).detach().clone() for n in names}
        step0 = exe._step
        want = _steps(exe, main, loss, batches, start, step0, False)
        hits = compile_cache.counter_value('executor/plan_cache_hit')
        got = _steps(exe, main, loss, batches, start, step0, True)
        assert compile_cache.counter_value(
            'executor/plan_cache_hit') - hits == STEPS - 1
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b), (got[0], want[0])
    assert not np.array_equal(got[0][0], got[0][-1])  # the steps train
    differ = [n for n in names if not torch.equal(got[1][n], want[1][n])]
    assert not differ, differ


_DP_WORKER = torch_dist_cases.PRELUDE + r'''
import json
import paddle_tpu_torch.fluid as fluid

def build():
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='int64')
        h = fluid.layers.fc(x, 16, act='relu')
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss

rng = np.random.RandomState(5)
batches = [{'x': rng.randn(4, 8).astype('float32'),
            'y': rng.randint(0, 4, (4, 1)).astype('int64')}
           for _ in range(3)]
main, startup, loss = build()
exe = fluid.Executor(fluid.CPUPlace())
prog = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
runs = {}
with fluid.scope_guard(fluid.Scope()):
    exe.run(startup)
    scope = fluid.global_scope()
    names = sorted(scope.local_var_names())
    start = {n: scope.find_var(n).clone() for n in names}
    for cache in (False, True):
        for n, v in start.items():
            scope.set_var(n, v.clone())
        exe._step = 1
        losses = [float(exe.run(prog, feed=b, fetch_list=[loss],
                                use_program_cache=cache)[0])
                  for b in batches]
        runs[cache] = (losses, {n: scope.find_var(n).clone()
                                for n in names})
res = {'losses': [runs[False][0], runs[True][0]],
       'bitwise': all(torch.equal(runs[False][1][n], runs[True][1][n])
                      for n in names),
       'n_state': len(names)}
with open(os.path.join(sys.argv[1], 'rank%d.json' % rank), 'w') as f:
    json.dump(res, f)
'''


def test_data_parallel_cached_is_bitwise_uncached(tmp_path):
    """with_data_parallel on 2 gloo ranks: the cached runs (the plan
    keyed with the replica's world and rank) are bitwise the uncached
    ones on each rank."""
    ranks = torch_dist_cases.Ranks(tmp_path, _DP_WORKER, 2,
                                   args=[str(tmp_path)])
    ranks.wait()
    for r in range(2):
        with open(os.path.join(str(tmp_path), 'rank%d.json' % r)) as f:
            res = json.load(f)
        assert res['losses'][0] == res['losses'][1], res
        assert res['bitwise'] and res['n_state'] > 4, res


def _fc(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[6], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='int64')
        logits = fluid.layers.fc(fluid.layers.fc(x, 8, act='relu'), 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        test = main.clone(for_test=True)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, test, loss, logits


def _sequence(fluid, place, counts):
    """The run sequence, each call followed by the (hit, miss) deltas
    that counts() reports."""
    main, startup, test, loss, logits = _fc(fluid)
    rng = np.random.RandomState(0)
    feed = {'x': rng.randn(4, 6).astype('float32'),
            'y': rng.randint(0, 3, (4, 1)).astype('int64')}
    exe = fluid.Executor(place)
    out = []

    def step(fn):
        h0, m0 = counts()
        fn()
        h1, m1 = counts()
        out.append((h1 - h0, m1 - m0))

    with fluid.scope_guard(fluid.Scope()):
        step(lambda: exe.run(startup))
        step(lambda: exe.run(main, feed=feed, fetch_list=[loss]))
        step(lambda: exe.run(main, feed=feed, fetch_list=[loss]))
        step(lambda: exe.run(main, feed=feed, fetch_list=[loss, logits]))
        step(lambda: exe.run(test, feed=feed, fetch_list=[loss]))
        step(lambda: exe.run(test, feed=feed, fetch_list=[loss]))
        with fluid.program_guard(main, startup):
            doubled = fluid.layers.scale(loss, scale=2.0)
        step(lambda: exe.run(main, feed=feed, fetch_list=[doubled]))
        step(lambda: exe.run(main, feed=feed, fetch_list=[doubled],
                             use_program_cache=False))
        step(lambda: exe.run(main, feed=feed, fetch_list=[doubled]))
        step(lambda: exe.run(main, feed=feed, fetch_list=[loss, logits]))
    return out


def test_hits_and_misses_match_jax():
    def jcounts():
        return (jmonitor.counter_value('executor/plan_cache_hit'),
                jmonitor.counter_value('executor/plan_cache_miss'))

    def tcounts():
        return (compile_cache.counter_value('executor/plan_cache_hit'),
                compile_cache.counter_value('executor/plan_cache_miss'))

    want = _sequence(jfluid, jfluid.XLAPlace(0), jcounts)
    got = _sequence(tfluid, tfluid.CPUPlace(), tcounts)
    assert got == want
    # the sequence exercises both outcomes
    assert (1, 0) in got and (0, 1) in got and (0, 0) in got


def test_bypass_leaves_the_cache_alone():
    """use_program_cache=False builds a plan for the call only."""
    main, startup, _, loss, _ = _fc(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.ones((2, 6), 'float32'),
            'y': np.zeros((2, 1), 'int64')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        n = compile_cache.counter_value('executor/plan_cache_bypass')
        exe.run(main, feed=feed, fetch_list=[loss], use_program_cache=False)
        assert len(main._exec_cache) == 0
        assert compile_cache.counter_value(
            'executor/plan_cache_bypass') == n + 1
        exe.run(main, feed=feed, fetch_list=[loss])
        assert len(main._exec_cache) == 1


def test_plan_flags_key_the_plan():
    """A flag that changes the plan (the fused optimizer runs) keys it:
    flipping it builds another plan, flipping it back hits the first."""
    main, startup, _, loss, _ = _fc(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.ones((2, 6), 'float32'),
            'y': np.zeros((2, 1), 'int64')}
    saved = tfluid.get_flags('FLAGS_torch_opt_fuse')
    try:
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            exe.run(main, feed=feed, fetch_list=[loss])
            tfluid.set_flags({'FLAGS_torch_opt_fuse': False})
            exe.run(main, feed=feed, fetch_list=[loss])
            assert len(main._exec_cache) == 2
            tfluid.set_flags(saved)
            h = compile_cache.counter_value('executor/plan_cache_hit')
            exe.run(main, feed=feed, fetch_list=[loss])
            assert compile_cache.counter_value(
                'executor/plan_cache_hit') == h + 1
    finally:
        tfluid.set_flags(saved)


def test_plan_cache_capacity_evicts():
    main, startup, _, loss, logits = _fc(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.ones((2, 6), 'float32'),
            'y': np.zeros((2, 1), 'int64')}
    saved = tfluid.get_flags('FLAGS_plan_cache_capacity')
    try:
        tfluid.set_flags({'FLAGS_plan_cache_capacity': 2})
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            ev = compile_cache.counter_value('executor/plan_cache_evictions')
            for fetch in ([loss], [logits], [loss, logits], [loss]):
                exe.run(main, feed=feed, fetch_list=fetch)
            assert len(main._exec_cache) == 2
            assert compile_cache.counter_value(
                'executor/plan_cache_evictions') == ev + 2
    finally:
        tfluid.set_flags(saved)


def test_scope_struct_version_and_binder():
    """A new name bumps the scope's structural version, an overwrite
    does not; a name set in a child scope after a run shadows its
    parent's in the next run, through the binder's revalidation."""
    parent = tfluid.Scope()
    kid = parent.new_scope()
    t0 = kid._chain_token()
    parent.set_var('a', 1)
    assert kid._chain_token() == t0 + 1
    parent.set_var('a', 2)
    assert kid._chain_token() == t0 + 1
    kid.var('b')
    parent.erase('a')
    assert kid._chain_token() == t0 + 3

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[3], dtype='float32')
        y = tfluid.layers.fc(x, 2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    outer = tfluid.Scope()
    feed = {'x': np.ones((1, 3), 'float32')}
    with tfluid.scope_guard(outer):
        exe.run(startup)
    inner = outer.new_scope()
    with tfluid.scope_guard(inner):
        first = exe.run(main, feed=feed, fetch_list=[y])[0]
        w = main.all_parameters()[0].name
        inner.set_var(w, torch.zeros_like(outer.find_var(w)))
        second = exe.run(main, feed=feed, fetch_list=[y])[0]
    assert not np.array_equal(first, second)
    bias = outer.find_var(main.all_parameters()[1].name).numpy()
    assert np.array_equal(second, bias[None, :])


def _forward():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[4], dtype='float32')
        ids = tfluid.layers.data('ids', shape=[1], dtype='int64')
        emb = tfluid.layers.embedding(ids, size=[10, 4], is_sparse=True)
        h = tfluid.layers.fc(tfluid.layers.elementwise_add(
            x, tfluid.layers.reshape(emb, [-1, 4])), 3)
        loss = tfluid.layers.mean(h)
    return main, startup, loss


def _fleet(main, startup, loss):
    from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet
    with tfluid.program_guard(main, startup):
        fleet.distributed_optimizer(tfluid.optimizer.SGD(0.1)).minimize(
            loss)


def _grad_allreduce(main, startup, loss):
    from paddle_tpu_torch.fluid.transpiler import GradAllReduce
    with tfluid.program_guard(main, startup):
        tfluid.optimizer.SGD(0.1).minimize(loss)
    GradAllReduce().transpile(startup, main, 0, ['127.0.0.1:6170'],
                              '127.0.0.1:6170')


def _distribute(main, startup, loss):
    from paddle_tpu_torch.fluid.transpiler import DistributeTranspiler
    DistributeTranspiler().transpile(0, program=main)


def _adagrad(main, startup, loss):
    # fuses each lookup's grad and adagrad op into fused_emb_update,
    # removing ops (Block._remove_op)
    with tfluid.program_guard(main, startup):
        tfluid.optimizer.Adagrad(0.1).minimize(loss)
    assert any(op.type == 'fused_emb_update'
               for op in main.global_block().ops)


# every rewrite of a Program in the port: each must bump its version,
# and so empty the plans it cached
REWRITES = {
    'append_op': lambda m, s, l: m.global_block().append_op(
        'scale', inputs={'X': l}, outputs={'Out': l},
        attrs={'scale': 2.0}),
    'insert_op': lambda m, s, l: m.global_block()._insert_op(
        0, 'scale', inputs={'X': 'x'}, outputs={'Out': 'x'},
        attrs={'scale': 1.0}),
    'remove_op': lambda m, s, l: m.global_block()._remove_op(
        len(m.global_block().ops) - 1),
    'create_var': lambda m, s, l: m.global_block().create_var(
        name='extra', shape=(1,), dtype='float32'),
    'append_backward': lambda m, s, l: tfluid.append_backward(l),
    'amp_marks': lambda m, s, l: decorator._mark_amp_ops(
        m, tfluid.contrib.mixed_precision.AutoMixedPrecisionLists()),
    'adagrad_emb_update': _adagrad,
    'grad_allreduce': _grad_allreduce,
    'distribute_transpiler': _distribute,
    'fleet_collective': _fleet,
}


@pytest.mark.parametrize('rewrite', sorted(REWRITES))
def test_every_rewrite_bumps_the_version(rewrite):
    main, startup, loss = _forward()
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.ones((2, 4), 'float32'),
            'ids': np.array([[1], [3]], 'int64')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
    assert len(main._exec_cache) == 1
    version = main._version
    with tfluid.unique_name.guard('rewrite_'):
        REWRITES[rewrite](main, startup, loss)
    assert main._version > version
    assert len(main._exec_cache) == 0


def test_clone_and_pruned_programs_start_their_own_cache():
    main, startup, loss = _forward()
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {'x': np.ones((2, 4), 'float32'),
            'ids': np.array([[1], [3]], 'int64')}
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        test = main.clone(for_test=True)
        pruned = tio._prune_for_inference(main, ['x', 'ids'], [loss])
        assert len(test._exec_cache) == 0 and len(pruned._exec_cache) == 0
        assert pruned._version > 0  # its ops were cut after the clone
        for prog in (test, pruned):
            got = exe.run(prog, feed=feed, fetch_list=[loss])[0]
            assert len(prog._exec_cache) == 1
            assert np.array_equal(
                got, exe.run(main, feed=feed, fetch_list=[loss])[0])
    assert len(main._exec_cache) == 1


def test_a_cached_plan_does_not_keep_a_dead_scope_alive():
    """The plan outlives the scopes it ran on (the program holds it);
    its binder tables are keyed weakly, so a dropped scope's tensors
    are freed."""
    import gc
    import weakref
    main, startup, _, loss, _ = _fc(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed={'x': np.ones((2, 6), 'float32'),
                            'y': np.zeros((2, 1), 'int64')},
                fetch_list=[loss])
    param = weakref.ref(scope.find_var(main.all_parameters()[0].name))
    del scope
    gc.collect()
    assert len(main._exec_cache) == 1 and param() is None

"""The port's static verifier against the JAX package's: every mutation
kind on LeNet-5, a tiny BERT and a While program gives the same
diagnostic classes at the same op indices in both packages, the clean
programs give no error in either, and the executor's plan-build hook
(the progcheck.mutate fault site under FLAGS_program_verify) refuses a
mutated program by name."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.fluid import progcheck as jpc
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import lenet as jlenet
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import faultinject as tfi
from paddle_tpu_torch.fluid import progcheck as tpc
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import lenet as tlenet

PKGS = (('jax', jfluid, jpc, jlenet, jbert),
        ('torch', tfluid, tpc, tlenet, tbert))


@pytest.fixture(autouse=True)
def _clean():
    yield
    for _, fluid, pc, _, _ in PKGS:
        fluid.set_flags({'FLAGS_program_verify': False,
                         'FLAGS_faultinject': ''})
        pc.reset()
    tfi.reset()


def _lenet(fluid, lenet, bert):
    feeds, pred, loss, acc = lenet.build()
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return list(feeds), [loss, acc]


def _bert(fluid, lenet, bert):
    feeds, enc, loss = bert.build_pretrain(bert.TINY, seq_len=16)
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return list(feeds), [loss]


def _while(fluid, lenet, bert):
    layers = fluid.layers
    x = layers.data('x', shape=[2, 4], dtype='float32',
                    append_batch_size=False)
    x.stop_gradient = False
    w = layers.create_parameter(
        [4], 'float32', name='w_loop',
        default_initializer=fluid.initializer.Constant(1.5))
    i = layers.fill_constant([1], 'float32', 0)
    n = layers.fill_constant([1], 'float32', 3)
    acc = layers.fill_constant([2, 4], 'float32', 0.0)
    cond = layers.less_than(i, n)
    wh = layers.While(cond, max_trip_count=4)
    with wh.block():
        t = layers.elementwise_mul(acc, w)
        layers.assign(layers.elementwise_add(t, x), acc)
        layers.increment(i)
        layers.assign(layers.less_than(i, n), cond)
    loss = layers.mean(acc)
    fluid.optimizer.SGD(0.1).minimize(loss)
    return ['x'], [loss]


BUILDERS = (('lenet', _lenet), ('bert', _bert), ('while', _while))


def _build(key, fluid, lenet, bert, builder):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, fetch = builder(fluid, lenet, bert)
    fetch = [getattr(v, 'name', v) for v in fetch]
    if key == 'jax':
        plan = jfluid.Executor(jfluid.CPUPlace())._build_plan(
            main, tuple(sorted(feeds)), tuple(fetch))
    else:
        plan = texecutor._build_plan(main, fetch)
    return main, startup, feeds, fetch, plan


def _verify(pc, main, startup, feeds, fetch, plan):
    rep = pc.verify_program(main, feed_names=feeds, fetch_names=fetch,
                            plan=plan, level='full', raise_on_error=False,
                            startup_program=startup)
    return sorted((d.cls, d.block_idx, d.op_index, d.op_type)
                  for d in rep.diagnostics)


def test_clean_programs_verify_alike_without_errors():
    for name, builder in BUILDERS:
        out = {}
        for key, fluid, pc, lenet, bert in PKGS:
            main, startup, feeds, fetch, plan = _build(
                key, fluid, lenet, bert, builder)
            out[key] = _verify(pc, main, startup, feeds, fetch, plan)
            assert not [d for d in out[key] if d[0] in pc.ERROR_CLASSES], \
                (name, key, out[key])
        assert out['jax'] == out['torch'], (name, out)


@pytest.mark.parametrize('kind', sorted(jpc.MUTATIONS))
def test_each_mutation_gives_the_same_diagnostics(kind):
    assert tpc.MUTATIONS == jpc.MUTATIONS
    for name, builder in BUILDERS:
        out = {}
        for key, fluid, pc, lenet, bert in PKGS:
            main, startup, feeds, fetch, plan = _build(
                key, fluid, lenet, bert, builder)
            applied = pc.mutate(main, kind, plan=plan)
            out[key] = (applied, _verify(pc, main, startup, feeds, fetch,
                                         plan))
        assert out['jax'] == out['torch'], (name, kind, out)
        applied, diags = out['torch']
        if applied is not None:
            assert applied[1] in [d[0] for d in diags], (name, kind, out)


def test_plan_build_hook_refuses_a_mutated_program_by_name():
    main, startup, feeds, fetch, _ = _build('torch', tfluid, tlenet, tbert,
                                           _lenet)
    feed = {'img': np.zeros((2, 1, 28, 28), 'float32'),
            'label': np.zeros((2, 1), 'int64')}
    before = tpc.report()['counters']['mutations']
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tfluid.set_flags({'FLAGS_program_verify': True})
        tfi.configure('progcheck.mutate:mutate:1')
        with pytest.raises(tpc.ProgramVerifyError, match='undefined_read'):
            exe.run(main, feed=feed, fetch_list=fetch)
    assert tfi.fired('progcheck.mutate') == 1
    rep = tpc.report()
    assert rep['counters']['mutations'] == before + 1
    assert rep['by_class'].get('undefined_read')


def test_warmup_and_transpile_verify_forced():
    main, startup, feeds, fetch, _ = _build('torch', tfluid, tlenet, tbert,
                                           _lenet)
    before = tpc.report()['counters']['programs']
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        exe.warmup(main, {'img': ((4, 1, 28, 28), 'float32'),
                          'label': ((4, 1), 'int64')}, fetch)
    assert tpc.report()['counters']['programs'] == before + 1
    assert tpc.report()['reports'][-1]['origin'] == 'warmup'
    t = tfluid.transpiler.GradAllReduce()
    t.transpile(startup_program=startup, main_program=main, rank=0,
                endpoints='127.0.0.1:6170', current_endpoint='127.0.0.1:6170',
                wait_port=False)
    origins = [r['origin'] for r in tpc.report()['reports']]
    assert 'transpile:GradAllReduce' in origins
    assert 'transpile:bucket' in origins
    with pytest.raises(NotImplementedError, match='item 13'):
        tpc.check_sharding({'w': (4, 4)}, {'w': ('dp', None)}, {'dp': 2})

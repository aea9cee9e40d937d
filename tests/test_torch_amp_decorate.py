"""fluid.contrib.mixed_precision.decorate in the port against the JAX
package, on the CPU.

The decorated Program serializes as the JAX package's (op types,
inputs, outputs, attributes with the AMP marks, vars, the startup
program with the loss scale and its counters).  Then the port's
versions of the JAX package's AMP semantics tests
(tests/test_amp_semantics.py): an overflowing step leaves SGD's and
Momentum's parameters as they are and decays the scale; good steps grow
it; gray ops follow a bf16 input (the master parameters and their
gradients stay f32); the loss of softmax_with_cross_entropy is f32;
mul of mixed dtypes promotes.  The loss scale and its counters move
between the packages by name, and FLAGS_check_nan_inf treats an AMP
step as the JAX package does.

Tolerances: the scale and counters exact; parameters after an
overflowing SGD or Momentum step exact (a zero gradient); the fc net's
loss after a state handed over from the JAX package within rel 1e-2
(bf16 products: both round each product and bias add to bf16, in other
summation orders).
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import bert as tbert


def _norm_dtype(name):
    # the JAX package narrows int64 to int32 (x64 off); the port keeps it
    return 'int' if name in ('int32', 'int64') else name


def _assert_same_block(jb, tb):
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    for jo, to in zip(jb['ops'], tb['ops']):
        assert jo['inputs'] == to['inputs'], jo['type']
        assert jo['outputs'] == to['outputs'], jo['type']
        strip = ('__op_callstack__',)
        assert {k: v for k, v in jo['attrs'].items() if k not in strip} == \
            {k: v for k, v in to['attrs'].items() if k not in strip}, \
            jo['type']
    jv = {v['name']: v for v in jb['vars']}
    tv = {v['name']: v for v in tb['vars']}
    assert jv.keys() == tv.keys()
    for name, v in jv.items():
        assert v['shape'] == tv[name]['shape'], name
        assert _norm_dtype(v['dtype']) == _norm_dtype(tv[name]['dtype']), \
            name
        for key in ('persistable', 'is_parameter', 'stop_gradient'):
            assert v[key] == tv[name][key], (name, key)


def _bert(fluid, bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.1, attn_dropout=0.1)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(cfg, seq_len=64)
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(1e-4), use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    return main, startup


def _mlp(fluid, opt_name='sgd', loss_kind='square', incr_every=3,
         decr_every=1, init_scale=2.0 ** 10, dynamic=True):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 16, act='relu')
        if loss_kind == 'square':
            y = fluid.layers.data('y', shape=[1], dtype='float32')
            pred = fluid.layers.fc(h, 1)
            loss = fluid.layers.mean(
                fluid.layers.square_error_cost(pred, y))
        else:
            y = fluid.layers.data('y', shape=[1], dtype='int64')
            logits = fluid.layers.fc(h, 4)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, y))
        inner = {'sgd': lambda: fluid.optimizer.SGD(0.01),
                 'momentum': lambda: fluid.optimizer.Momentum(0.01, 0.9),
                 'adam': lambda: fluid.optimizer.Adam(0.01)}[opt_name]()
        opt = fluid.contrib.mixed_precision.decorate(
            inner, init_loss_scaling=init_scale,
            use_dynamic_loss_scaling=dynamic, incr_every_n_steps=incr_every,
            decr_every_n_nan_or_inf=decr_every)
        opt.minimize(loss)
    return main, startup, loss, opt.get_loss_scaling()


def _feed(seed=0, kind='square', batch=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 8).astype('float32')
    y = (rng.randn(batch, 1).astype('float32') if kind == 'square' else
         rng.randint(0, 4, (batch, 1)).astype('int64'))
    return {'x': x, 'y': y}


def _val(scope, name):
    return np.asarray(scope.find_var(name)).copy()


@pytest.mark.parametrize('which', ['bert_adam', 'mlp_swce_static'])
def test_decorated_program_serializes_like_jax(which):
    """The main and startup programs after decorate(...).minimize: the
    same ops with the same AMP marks, the scaled loss, the loss-scaling
    ops after the backward and the persistable scale and counters."""
    if which == 'bert_adam':
        (jm, js), (tm, ts) = _bert(jfluid, jbert), _bert(tfluid, tbert)
    else:
        jm, js = _mlp(jfluid, loss_kind='swce', dynamic=False)[:2]
        tm, ts = _mlp(tfluid, loss_kind='swce', dynamic=False)[:2]
    for jp, tp in ((jm, tm), (js, ts)):
        (jb,), (tb,) = jp.to_dict()['blocks'], tp.to_dict()['blocks']
        _assert_same_block(jb, tb)
    types = [op.type for op in tm.global_block().ops]
    assert 'check_finite_and_unscale' in types
    assert ('update_loss_scaling' in types) == (which == 'bert_adam')
    marks = {op.type: sorted(k for k in op.attrs if k.startswith('__amp'))
             for op in tm.global_block().ops if '_grad' not in op.type}
    assert marks['mul'] == ['__amp__']
    assert marks['elementwise_add'] == ['__amp_gray__']
    assert marks['softmax_with_cross_entropy'] == ['__amp_black_out__']
    assert marks.get('layer_norm', []) == []
    names = weights.startup_names(ts)
    assert 'loss_scaling_0' in names
    assert ('good_steps_0' in names) == (which == 'bert_adam')


def test_overflow_skips_sgd_update_and_decays_scale():
    main, startup, loss, scale = _mlp(tfluid)
    feed = _feed()
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        pname = main.all_parameters()[0].name
        p0 = _val(scope, pname)
        exe.run(main, feed=feed, fetch_list=[])
        p1 = _val(scope, pname)
        assert not np.allclose(p0, p1)
        assert _val(scope, scale.name).tolist() == [2.0 ** 10]
        exe.run(main, feed=dict(feed, x=feed['x'] * 1e30), fetch_list=[])
        np.testing.assert_array_equal(_val(scope, pname), p1)
        assert _val(scope, scale.name).tolist() == [2.0 ** 9]
        assert scope.find_var(pname).dtype == torch.float32


def test_overflow_leaves_momentum_parameters_and_velocities():
    """Momentum fed zero gradients: v = mu * v, p -= lr * v.  At step 1
    the velocity is 0, so an overflow on the first step moves nothing;
    the scale halves."""
    main, startup, loss, scale = _mlp(tfluid, 'momentum')
    feed = _feed(1)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        names = [n for n in weights.startup_names(startup)
                 if 'loss_scaling' not in n and '_steps_' not in n]
        before = {n: _val(scope, n) for n in names}
        exe.run(main, feed=dict(feed, x=feed['x'] * 1e30), fetch_list=[])
        for n in names:
            np.testing.assert_array_equal(_val(scope, n), before[n], n)
        assert _val(scope, scale.name).tolist() == [2.0 ** 9]


def test_scale_grows_after_n_good_steps():
    main, startup, loss, scale = _mlp(tfluid, incr_every=3)
    feed = _feed(1)
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        scales = []
        for _ in range(7):
            exe.run(main, feed=feed, fetch_list=[])
            scales.append(float(_val(scope, scale.name)[0]))
            assert scope.find_var('good_steps_0').dtype == torch.int32
    assert scales == [2.0 ** 10] * 2 + [2.0 ** 11] * 3 + [2.0 ** 12] * 2


def test_gray_ops_follow_bf16_and_masters_stay_f32():
    """The bias add fed a bf16 product and an f32 bias casts the bias
    down: its output is bf16.  The parameters in the scope and their
    gradients stay f32 (the casts sit inside autograd)."""
    main, startup, loss, _ = _mlp(tfluid)
    add_out = [op.output('Out')[0] for op in main.global_block().ops
               if op.type == 'elementwise_add'
               and op.attrs.get('__amp_gray__')][0]
    params = [p.name for p in main.all_parameters()]
    grads = [main._grad_name_map[p] for p in params]
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        out = exe.run(main, feed=_feed(), fetch_list=[add_out, loss] + grads,
                      return_numpy=False)
    assert out[0].dtype == torch.bfloat16
    assert out[1].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in out[2:])
    assert all(scope.find_var(p).dtype == torch.float32 for p in params)


def test_amp_loss_output_is_f32():
    main, startup, loss, _ = _mlp(tfluid, loss_kind='swce', dynamic=False)
    swce = [op for op in main.global_block().ops
            if op.type == 'softmax_with_cross_entropy'][0]
    assert swce.attrs.get('__amp_black_out__')
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        out, = exe.run(main, feed=_feed(kind='swce'),
                       fetch_list=[swce.output('Loss')[0]],
                       return_numpy=False)
    assert out.dtype == torch.float32


def test_mul_mixed_dtype_promotes():
    """mul without AMP on a bf16 X and an f32 W promotes to f32, as
    jnp does."""
    from paddle_tpu_torch.ops import registry
    out = registry.get('mul').run(
        registry.LowerCtx(0), {'X': [torch.ones(2, 3, dtype=torch.bfloat16)],
                               'Y': [torch.ones(3, 4)]}, {})['Out'][0]
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.full((2, 4), 3.0))


def test_loss_scaling_state_moves_from_a_jax_scope():
    """The JAX package trains 4 steps (one overflowing); the port takes
    its whole state by name (the loss scale and the good and bad
    counters among it) and both take 2 more steps: the scale and the
    counters exact, the losses within rel 1e-2."""
    jm, js, jl, jscale = _mlp(jfluid, 'adam', incr_every=2, decr_every=2)
    tm, ts, tl, tscale = _mlp(tfluid, 'adam', incr_every=2, decr_every=2)
    names = weights.startup_names(ts)
    assert {'loss_scaling_0', 'good_steps_0', 'bad_steps_0'} <= set(names)
    feeds = [_feed(i) for i in range(6)]
    feeds[2] = dict(feeds[2], x=feeds[2]['x'] * 1e30)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        for f in feeds[:4]:
            jexe.run(jm, feed=f, fetch_list=[])
        state = weights.numpy_state(jscope, names)
        jloss = [float(jexe.run(jm, feed=f, fetch_list=[jl])[0])
                 for f in feeds[4:]]
        jstate = weights.numpy_state(jscope, names)
    assert state['good_steps_0'].tolist() == [1]
    assert state['bad_steps_0'].tolist() == [0]
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(), ts)
        tloss = [float(texe.run(tm, feed=f, fetch_list=[tl])[0])
                 for f in feeds[4:]]
        tstate = weights.numpy_state(tscope, names)
    for n in ('loss_scaling_0', 'good_steps_0', 'bad_steps_0'):
        assert tstate[n].dtype == jstate[n].dtype
        np.testing.assert_array_equal(tstate[n], jstate[n], n)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)


@pytest.fixture
def check_nan_inf():
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    jfluid.set_flags({'FLAGS_check_nan_inf': True})
    yield
    tflags.set_flags({'FLAGS_check_nan_inf': False})
    jfluid.set_flags({'FLAGS_check_nan_inf': False})


def _nan_check_outcome(fluid, place, fetch):
    main, startup, loss, _ = _mlp(fluid, 'adam')
    feed = _feed(2)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        try:
            exe.run(main, feed=dict(feed, x=feed['x'] * 1e30),
                    fetch_list=[loss] if fetch else [])
        except FloatingPointError as e:
            return str(e).split('\n')[0]
    return None


@pytest.mark.parametrize('fetch', [False, True])
def test_check_nan_inf_on_an_amp_step_matches_jax(check_nan_inf, fetch):
    """The overflow the loss scaling absorbs passes the check; a fetched
    non-finite loss raises naming it, and only it: the JAX package
    checks the values a step writes to the scope and its fetches."""
    want = _nan_check_outcome(jfluid, jfluid.CPUPlace(), fetch)
    got = _nan_check_outcome(tfluid, tfluid.CPUPlace(), fetch)
    assert got == want
    assert (got is None) == (not fetch)

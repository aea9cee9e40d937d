"""The port's LeNet-5 slice against the JAX package, on the CPU.

Ops (forward and the gradient of every floating input, from the same
seeded inputs and cotangents; tolerances in tests/torch_image_cases.py:
forward rtol 1e-5 with a floor of 1e-5 of the largest output, gradients
within 1e-4 of the largest): softmax, cross_entropy and cross_entropy2,
top_k and accuracy, sgd and momentum.  Then the modules around them:
the synthetic MNIST reader (bitwise the JAX package's arrays),
metrics.Accuracy, Variable's operators, and LeNet-5 itself, whose
Program serializes like the JAX package's and which trains 3 steps with
Adam (lr 1e-3) and with SGD (lr 0.01) at batch 64 to within rel 1e-5
of the JAX package's losses (f32 on both sides, summed in other
orders).  Last the executor's FLAGS_check_nan_inf and
return_numpy='async'.

Every test that builds a Program does so inside both packages' own
unique_name.guard and program_guard; a test that sets a flag of either
package puts it back.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.dataset import mnist as jmnist
from paddle_tpu.fluid import metrics as jmetrics
from paddle_tpu.models import lenet as jlenet

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.dataset import mnist as tmnist
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.fluid import metrics as tmetrics
from paddle_tpu_torch.models import lenet as tlenet

from torch_image_cases import check_op, same_block

_R = np.random.RandomState(0)
BATCH = 64  # the reference test_recognize_digits.py's batch
STEPS = 3


def _f(*shape):
    return _R.randn(*shape).astype('float32')


def _probs(n, c):
    e = np.exp(_f(n, c))
    return (e / e.sum(axis=1, keepdims=True)).astype('float32')


@pytest.mark.parametrize('axis', [-1, 1])
def test_softmax_matches_jax(axis):
    check_op('softmax', {'X': [_f(3, 4, 5) * 3]}, {'axis': axis}, seed=1)


_LABELS = _R.randint(0, 7, (6, 1)).astype('int64')
CE_CASES = [
    ('hard_n1', 'cross_entropy', _probs(6, 7), _LABELS, {}),
    ('hard_n', 'cross_entropy', _probs(6, 7), _LABELS[:, 0], {}),
    # an ignored row gives 0 and no gradient; a zero probability is
    # clipped at 1e-20
    ('ignore_and_clip', 'cross_entropy',
     np.where(np.arange(7) == 2, 0.0, _probs(6, 7)).astype('float32'),
     np.array([[2], [-1], [1], [-1], [0], [6]], 'int64'),
     {'ignore_index': -1}),
    ('soft_label', 'cross_entropy', _probs(6, 7), _probs(6, 7),
     {'soft_label': True}),
    ('cross_entropy2', 'cross_entropy2', _probs(6, 7), _LABELS, {}),
]


@pytest.mark.parametrize('case', CE_CASES, ids=[c[0] for c in CE_CASES])
def test_cross_entropy_matches_jax(case):
    _, op, x, label, attrs = case
    a = {'soft_label': False, 'ignore_index': -100}
    a.update(attrs)
    want, got = check_op(op, {'X': [x], 'Label': [label]}, a, seed=2,
                         fwd_slots=['Y'])
    if case[0] == 'ignore_and_clip':
        assert got['Y'][0][1, 0] == 0 and got['Y'][0][3, 0] == 0
        np.testing.assert_allclose(got['Y'][0][0, 0], -np.log(1e-20),
                                   rtol=1e-6)


def test_top_k_and_accuracy_match_jax():
    """top_k keeps equal values in index order (as jax.lax.top_k), so a
    tie gives the JAX package's indices; accuracy is an f32 share,
    Correct and Total int32."""
    x = _f(8, 10)
    x[0, 3] = x[0, 7] = 9.0
    x[1, :] = 1.0
    want, got = check_op('top_k', {'X': [x]}, {'k': 3}, seed=3)
    np.testing.assert_array_equal(got['Indices'][0][0, :2], [3, 7])
    np.testing.assert_array_equal(got['Indices'][0][1], [0, 1, 2])
    assert got['Indices'][0].dtype == np.int64
    label = np.array([[7], [1], [4], [0], [9], [2], [2], [5]], 'int64')
    ins = {'Out': [got['Out'][0]], 'Indices': [got['Indices'][0]],
           'Label': [label]}
    want, got = check_op('accuracy', ins, {})
    assert got['Accuracy'][0].dtype == np.float32
    assert got['Correct'][0].dtype == got['Total'][0].dtype == np.int32
    assert int(got['Total'][0]) == 8
    np.testing.assert_array_equal(got['Correct'][0], want['Correct'][0])


@pytest.mark.parametrize('op,attrs', [
    ('sgd', {}), ('momentum', {'mu': 0.9}),
    ('momentum', {'mu': 0.8, 'use_nesterov': True})],
    ids=['sgd', 'momentum', 'nesterov'])
def test_update_ops_match_jax(op, attrs):
    """The per-parameter LearningRate input (a [1] tensor, as a scaled
    rate for a parameter with its own learning_rate)."""
    ins = {'Param': [_f(4, 5)], 'Grad': [_f(4, 5)],
           'LearningRate': [np.array([0.05], 'float32')]}
    if op == 'momentum':
        ins['Velocity'] = [_f(4, 5)]
    want, got = check_op(op, ins, attrs, seed=4)
    for slot in want:
        np.testing.assert_allclose(got[slot][0], want[slot][0], rtol=1e-6,
                                   atol=1e-7)


def test_mnist_synthetic_is_the_jax_readers():
    imgs, labels = tmnist._synthetic(300, 7)
    jimgs, jlabels = jmnist._synthetic(300, 7)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    for t, j in ((tmnist.train(), jmnist.train()),
                 (tmnist.test(), jmnist.test())):
        tt, jj = list(t()), list(j())
        assert len(tt) == len(jj) and len(tt) in (2048, 512)
        np.testing.assert_array_equal(tt[5][0], jj[5][0])
        assert [s[1] for s in tt] == [s[1] for s in jj]


def test_metrics_accumulate_like_jax():
    streams = [(0.75, 64), (0.5, 32), (1.0, 8)]
    ta, ja = tmetrics.Accuracy(), jmetrics.Accuracy()
    for value, weight in streams:
        ta.update(value, weight)
        ja.update(value, weight)
    assert ta.eval() == ja.eval() == pytest.approx(
        sum(v * w for v, w in streams) / 104)
    preds = np.array([0.9, 0.2, 0.7, 0.4])
    labels = np.array([1, 0, 0, 1])
    for name in ('Precision', 'Recall'):
        t, j = getattr(tmetrics, name)(), getattr(jmetrics, name)()
        t.update(preds, labels)
        j.update(preds, labels)
        assert t.eval() == j.eval()
    ta.reset()
    with pytest.raises(ValueError):
        ta.eval()


def test_variable_operators_build_like_jax():
    """+ - * / ** and the comparisons with scalars, numpy arrays and
    Variables append the JAX package's ops (math_op_patch), and the
    port runs them."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 2
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data('x', shape=[3])
            y = fluid.layers.data('y', shape=[3])
            outs = [x + 1.5, 2.0 - x, x * y, x / 4.0, 1.0 / x, -x, x ** 2,
                    x + np.ones((1, 3), 'float32'), x < y, x >= 0.5,
                    x > y, x <= y]
        return main, outs
    jm, _ = build(jfluid)
    tm, outs = build(tfluid)
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    x = np.array([[0.5, 2.0, -1.0]], 'float32')
    y = np.array([[1.0, 2.0, -2.0]], 'float32')
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed={'x': x, 'y': y}, fetch_list=outs)
    want = [x + 1.5, 2.0 - x, x * y, x / 4.0, 1.0 / x, -x, x ** 2, x + 1,
            x < y, x >= 0.5, x > y, x <= y]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def _lenet(fluid, lenet_mod, opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, pred, loss, acc = lenet_mod.build()
        o = fluid.optimizer.Adam(1e-3) if opt == 'adam' else \
            fluid.optimizer.SGD(0.01)
        o.minimize(loss)
    return main, startup, loss, acc


def _batches():
    imgs, labels = tmnist._synthetic(BATCH * STEPS, 0)
    return [{'img': imgs[i * BATCH:(i + 1) * BATCH].reshape(-1, 1, 28, 28),
             'label': labels[i * BATCH:(i + 1) * BATCH].reshape(-1, 1)}
            for i in range(STEPS)]


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_lenet_program_serializes_like_jax(opt):
    jm, js, _, _ = _lenet(jfluid, jlenet, opt)
    tm, ts, _, _ = _lenet(tfluid, tlenet, opt)
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    same_block(js.to_dict()['blocks'][0], ts.to_dict()['blocks'][0])
    params = tm.all_parameters()
    # conv 20 x 1 x 5 x 5 + 20, conv 50 x 20 x 5 x 5 + 50, fc 800 x 10 + 10
    assert sum(int(np.prod(p.shape)) for p in params) == 33580
    assert len(params) == 6


@pytest.mark.parametrize('opt', ['adam', 'sgd'])
def test_lenet_trains_like_jax(opt):
    """3 steps from the JAX package's startup values on the same
    batches: losses within rel 1e-5, accuracies equal, the loss falls;
    metrics.Accuracy accumulates the fetched accuracy."""
    jm, js, jl, ja = _lenet(jfluid, jlenet, opt)
    tm, ts, tl, ta = _lenet(tfluid, tlenet, opt)
    names = weights.startup_names(ts)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        state = weights.numpy_state(jscope, names)
        jout = [[float(np.asarray(v)) for v in
                 jexe.run(jm, feed=b, fetch_list=[jl, ja])]
                for b in _batches()]
    tscope = tfluid.Scope()
    acc = tmetrics.Accuracy()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(), ts)
        tout = []
        for b in _batches():
            loss, a = texe.run(tm, feed=b, fetch_list=[tl, ta])
            tout.append([float(loss), float(a)])
            acc.update(a, BATCH)
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-5)
    assert [o[1] for o in tout] == [o[1] for o in jout]
    assert tout[-1][0] < tout[0][0]
    assert acc.eval() == pytest.approx(np.mean([o[1] for o in tout]))


def test_lenet_adam_is_one_fused_run():
    """The executor hands LeNet's 6 adam ops to one fused_adam run: one
    multi-tensor kernel launch a step on the card (here its plain
    version); SGD's ops are not grouped."""
    tm, _, _, _ = _lenet(tfluid, tlenet, 'adam')
    ops = tm.global_block().ops
    first = [op.type for op in ops].index('adam')
    run = texecutor._fused_opt_run(ops, first)
    assert run is not None and len(run) == 6
    sm, _, _, _ = _lenet(tfluid, tlenet, 'sgd')
    sops = sm.global_block().ops
    assert texecutor._fused_opt_run(
        sops, [op.type for op in sops].index('sgd')) is None


@pytest.fixture
def check_nan_inf():
    tflags.set_flags({'FLAGS_check_nan_inf': True})
    yield
    tflags.set_flags({'FLAGS_check_nan_inf': False})


def test_check_nan_inf_names_every_bad_variable(check_nan_inf):
    """The step's values are checked on the device and the error names
    every non-finite variable; a finite step passes."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[2])
        big = tfluid.layers.scale(x, scale=1e20)
        sq = tfluid.layers.elementwise_mul(big, big)
        ok = tfluid.layers.relu(tfluid.layers.scale(x, scale=-1.0))
        out = tfluid.layers.elementwise_sub(sq, sq)
    exe = tfluid.Executor(tfluid.CPUPlace())
    fine = exe.run(main, feed={'x': np.full((1, 2), 1e-10, 'float32')},
                   fetch_list=[out])
    assert np.isfinite(fine[0]).all()
    # big [1e30, 1e10] is finite, sq [inf, 1e20] and out [nan, 0] not
    with pytest.raises(FloatingPointError) as e:
        exe.run(main, feed={'x': np.array([[1e10, 1e-10]], 'float32')},
                fetch_list=[out])
    msg = str(e.value)
    assert '2 var(s)' in msg and sq.name in msg and out.name in msg
    assert big.name not in msg and ok.name not in msg


def test_fetch_handle_resolves_the_steps_value():
    """return_numpy='async': one FetchHandle a fetch; as_numpy() and
    np.asarray give the synchronous fetch's values, and a handle keeps
    the value its step left after a later step updates the variable."""
    tm, ts, tl, _ = _lenet(tfluid, tlenet, 'sgd')
    b = _batches()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(ts)
        h_loss, h_w = exe.run(tm, feed=b[0], fetch_list=[tl, 'fc_0.w_0'],
                              return_numpy='async')
        assert isinstance(h_loss, texecutor.FetchHandle)
        sync_w = exe.run(tm, feed=b[1], fetch_list=['fc_0.w_0'])[0]
        assert not np.array_equal(h_w.as_numpy(), sync_w)
        assert isinstance(h_w.value, torch.Tensor)
    assert h_loss.as_numpy().shape == ()
    np.testing.assert_array_equal(np.asarray(h_w), h_w.as_numpy())

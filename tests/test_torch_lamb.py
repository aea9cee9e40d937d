"""The port's LAMB: its multi-tensor update (the plain version of K5, on
the CPU) against the JAX package's fused LAMB run in interpret mode
(``fused_optimizer.apply('lamb')`` with FLAGS_pallas_force) and its
per-tensor dense lowerings; the trust-ratio edge cases; LambOptimizer's
program; and the executor's grouping of lamb runs, which must split a
program whose exclude_from_weight_decay_fn zeroes some tensors' decay
into exactly the runs the JAX executor makes.

Tolerance rtol 2e-6 / atol 3e-7, the JAX package's own bound between
its fused kernel and the dense chain (tests/test_pallas_kernels.py):
the trust ratio's norms are summed in another order, and one side may
contract a multiply-add the other rounds twice.  The fixture restores
every FLAGS_pallas_* flag of the JAX package and the port's grouping
flags.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import optimizer_ops as jopt
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.pallas import common as jcommon
from paddle_tpu.ops.pallas import fused_optimizer as jfused

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import optimizer_ops as topt
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import fused_optimizer as tfused

TOL = dict(rtol=2e-6, atol=3e-7)
SLOTS = ('Param', 'Grad', 'Moment1', 'Moment2', 'LearningRate', 'Beta1Pow',
         'Beta2Pow')
OUT_SLOTS = ('ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
             'Beta2PowOut')
ATTRS = {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-6, 'weight_decay': 0.01}
_PORT_FLAGS = ('FLAGS_torch_opt_fuse', 'FLAGS_torch_opt_min_tensors')


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = tflags.get_flags(list(_PORT_FLAGS))
    yield
    j_set_flags({k: v for k, v in J_DEFAULTS.items()
                 if k.startswith('FLAGS_pallas_')})
    tflags.set_flags(saved)


def _arrays(seed, zero_grad=(), zero_param=()):
    """Five tensors of mixed shapes, a [1] tensor among them, with
    their own learning rates and beta powers; `zero_grad` tensors get a
    zero gradient and zero moments, `zero_param` ones a zero value."""
    rng = np.random.RandomState(seed)
    shapes = [(33, 47), (128,), (5, 8, 13), (257,), (1,)]
    out = {k: [] for k in SLOTS}
    for i, s in enumerate(shapes):
        zg = i in zero_grad
        out['Param'].append(np.zeros(s, 'float32') if i in zero_param
                            else rng.randn(*s).astype('float32'))
        out['Grad'].append(np.zeros(s, 'float32') if zg
                           else rng.randn(*s).astype('float32'))
        out['Moment1'].append(np.zeros(s, 'float32') if zg
                              else rng.randn(*s).astype('float32'))
        out['Moment2'].append(np.zeros(s, 'float32') if zg
                              else np.abs(rng.randn(*s)).astype('float32'))
        out['LearningRate'].append(np.float32([0.001 * (i + 1)]))
        out['Beta1Pow'].append(np.float32([0.9 ** (i + 1)]))
        out['Beta2Pow'].append(np.float32([0.999 ** (i + 1)]))
    return out


def _jax(arrays):
    return {k: [jnp.asarray(a) for a in v] for k, v in arrays.items()}


def _torch(arrays):
    return {k: [torch.from_numpy(a.copy()) for a in v]
            for k, v in arrays.items()}


def _assert_outs(got, want, n=5, **tol):
    for slot in OUT_SLOTS:
        assert len(got[slot]) == len(want[slot]) == n
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg='%s %d' % (slot, i),
                                       **(tol or TOL))


@pytest.mark.parametrize('seed', [3, 11])
def test_fused_lamb_matches_pallas_interpret(seed):
    arrays = _arrays(seed)
    j_set_flags({'FLAGS_pallas_force': True})
    want = jfused.apply('lamb', jregistry.LowerCtx(0), _jax(arrays), ATTRS)
    assert jcommon._LAST['fused_optimizer']['reason'] == 'forced_interpret'
    before = common.launches('fused_lamb')
    got = tfused.apply('lamb', None, _torch(arrays), ATTRS)
    assert common.launches('fused_lamb') == before  # CPU: plain
    _assert_outs(got, want)


def test_fused_lamb_matches_jax_dense_run():
    arrays = _arrays(5)
    want = jfused._dense('lamb', jregistry.LowerCtx(0), _jax(arrays), ATTRS)
    got = tfused.apply('lamb', None, _torch(arrays), ATTRS)
    _assert_outs(got, want)


def test_per_tensor_lamb_lowering_matches_jax():
    arrays = _arrays(8)
    attrs = dict(ATTRS, beta1=0.85, beta2=0.99, weight_decay=0.1)
    for i in range(5):
        one = {k: [v[i]] for k, v in arrays.items()}
        want = jopt.lamb(jregistry.LowerCtx(0), _jax(one), attrs)
        got = topt.lamb(None, _torch(one), attrs)
        _assert_outs(got, want, n=1)


@pytest.mark.parametrize('case', ['zero_r', 'zero_p'])
def test_trust_ratio_edge_cases(case):
    """A tensor whose r-norm is 0 (zero gradient and moments, no decay)
    or whose p-norm is 0 takes trust = 1, while its run-mates take
    ||p|| / ||r||: per tensor, not per run."""
    if case == 'zero_r':
        arrays, attrs = _arrays(7, zero_grad=(1, 4)), dict(ATTRS,
                                                           weight_decay=0.0)
    else:
        arrays, attrs = _arrays(7, zero_param=(2,)), ATTRS
    j_set_flags({'FLAGS_pallas_force': True})
    want = jfused.apply('lamb', jregistry.LowerCtx(0), _jax(arrays), attrs)
    got = tfused.apply('lamb', None, _torch(arrays), attrs)
    _assert_outs(got, want)
    if case == 'zero_r':
        for i in (1, 4):  # a zero step
            np.testing.assert_array_equal(got['ParamOut'][i].numpy(),
                                          arrays['Param'][i])
        assert not np.array_equal(got['ParamOut'][0].numpy(),
                                  arrays['Param'][0])
    else:
        # trust 1: the zero tensor moves by lr * r, r = the Adam direction
        one = {k: [v[2]] for k, v in _torch(arrays).items()}
        step = one['Param'][0] - got['ParamOut'][2]
        m1 = got['Moment1Out'][2] / (1 - 0.9 ** 3 * 0.9)
        m2 = got['Moment2Out'][2] / (1 - 0.999 ** 3 * 0.999)
        r = m1 / (torch.sqrt(m2) + 1e-6)
        torch.testing.assert_close(step, 0.003 * r, rtol=1e-5, atol=1e-9)


def test_fused_plain_is_the_per_tensor_loop_bitwise():
    arrays = _arrays(9)
    got = tfused.apply('lamb', None, _torch(arrays), ATTRS)
    for i in range(5):
        want = topt.lamb(None, _torch({k: [v[i]] for k, v in arrays.items()}),
                         ATTRS)
        for slot in OUT_SLOTS:
            assert torch.equal(got[slot][i], want[slot][0]), (i, slot)


def test_group_key_takes_lamb_defaults_and_decay():
    """lamb ops group on epsilon (default 1e-6) and weight_decay too, as
    in the JAX executor."""

    class Op(object):
        def __init__(self, type, attrs):
            self.type, self.attrs = type, attrs

    for op in (Op('lamb', {}), Op('lamb', {'weight_decay': 0.0}),
               Op('lamb', dict(ATTRS)), Op('adam', {}),
               Op('adamw', {'coeff': 0.02})):
        assert texecutor._opt_group_key(op) == jexecutor._opt_group_key(op)
    assert texecutor._opt_group_key(Op('lamb', {}))[3] == 1e-6
    assert texecutor._FUSABLE_OPT['lamb'] == 'fused_lamb'


def _bert_lamb(fluid, bert_mod, exclude=None):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.1, attn_dropout=0.1)
    cfg.flash_min_len = 0
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(cfg, seq_len=64)
        fluid.optimizer.Lamb(1e-3, lamb_weight_decay=0.01,
                             exclude_from_weight_decay_fn=exclude
                             ).minimize(loss)
    return main, startup


def _runs(mod, ops):
    """(op type, run length, first ParamOut) of every fused run the
    executor's grouping makes, walking the ops as the executor does."""
    out, i = [], 0
    while i < len(ops):
        run = mod._fused_opt_run(ops, i) \
            if ops[i].type in mod._FUSABLE_OPT else None
        if run is not None:
            out.append((run[0].type, len(run),
                        run[0].outputs['ParamOut'][0]))
            i += len(run)
        else:
            i += 1
    return out


def _no_decay(p):
    # biases (<layer>.w_1) and every layer norm: the usual LAMB exclusions
    return p.name.endswith('.w_1') or p.name.startswith('layer_norm')


@pytest.mark.parametrize('exclude', [None, _no_decay],
                         ids=['all_decay', 'exclude_fn'])
def test_runs_split_as_in_the_jax_executor(exclude):
    jmain, _ = _bert_lamb(jfluid, jbert, exclude)
    tmain, _ = _bert_lamb(tfluid, tbert, exclude)
    jops = [op for op in jmain.global_block().ops
            if op.type not in ('feed', 'fetch')]
    tops = [op for op in tmain.global_block().ops
            if op.type not in tregistry.HOST_OPS]
    jruns, truns = _runs(jexecutor, jops), _runs(texecutor, tops)
    assert truns == jruns
    n_lamb = sum(op.type == 'lamb' for op in tops)
    if exclude is None:
        assert truns == [('lamb', n_lamb, tops[-n_lamb].outputs[
            'ParamOut'][0])]
    else:
        # decayed and excluded tensors alternate in name order: most runs
        # are single ops, which run unfused
        assert 1 < len(truns) and sum(n for _, n, _ in truns) < n_lamb
        decays = [op.attrs['weight_decay'] for op in tops
                  if op.type == 'lamb']
        assert 0.0 in decays and 0.01 in decays


def test_lamb_program_serializes_like_jax():
    """Per-parameter moments and beta powers (starting at 1.0, advanced
    by the lamb op itself: no finishing scale ops), the same attrs."""
    jmain, jstart = _bert_lamb(jfluid, jbert, _no_decay)
    tmain, tstart = _bert_lamb(tfluid, tbert, _no_decay)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        jb, tb = jp.to_dict()['blocks'][0], tp.to_dict()['blocks'][0]
        assert [o['type'] for o in jb['ops']] == \
            [o['type'] for o in tb['ops']]
        for jo, to in zip(jb['ops'], tb['ops']):
            assert (jo['inputs'], jo['outputs']) == \
                (to['inputs'], to['outputs']), jo['type']
            strip = ('__op_callstack__',)
            assert {k: v for k, v in jo['attrs'].items()
                    if k not in strip} == \
                {k: v for k, v in to['attrs'].items() if k not in strip}
    types = [op.type for op in tmain.global_block().ops]
    assert types[-1] == 'lamb' and 'scale' not in types[types.index('lamb'):]
    pows = [op for op in tstart.global_block().ops
            if op.outputs['Out'][0].endswith(('_beta1_pow_acc_0',
                                              '_beta2_pow_acc_0'))]
    n_params = len(tmain.all_parameters())
    assert len(pows) == 2 * n_params
    assert all(op.attrs['value'] == 1.0 and op.attrs['shape'] == [1]
               for op in pows)


def test_grouped_steps_equal_ungrouped_bitwise():
    feed = {'x': np.random.RandomState(0).randn(3, 6).astype('float32')}
    results = []
    for fuse in (True, False):
        tflags.set_flags({'FLAGS_torch_opt_fuse': fuse})
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 3
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            x = tfluid.layers.data('x', shape=[6], dtype='float32')
            h = tfluid.layers.fc(x, size=5, act='relu')
            loss = tfluid.layers.mean(tfluid.layers.fc(h, size=4))
            tfluid.optimizer.Lamb(0.01).minimize(loss)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe.run(startup)
            losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                      for _ in range(3)]
            results.append((losses, {n: scope.find_var(n).clone()
                                     for n in scope.local_var_names()}))
    (la, sa), (lb, sb) = results
    np.testing.assert_array_equal(la, lb)
    assert sa.keys() == sb.keys()
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
    b1 = [n for n in sa if 'beta1_pow' in n]
    assert len(b1) == 4
    for n in b1:  # each advanced once a step
        np.testing.assert_allclose(sa[n].numpy(), [0.9 ** 3], rtol=1e-6)

"""Wide&Deep CTR training with sparse Adagrad: the port against the JAX
package, on the CPU.

The port's models.wide_deep.build + AdagradOptimizer.minimize builds
the JAX package's program op for op: each embedding table's
lookup_table_v2_grad + adagrad pair is rewritten into one
fused_emb_update (the producer/consumer check, the dead grad op
removed, padding_idx carried over), every other parameter keeps its
adagrad op.  Three steps on TINY from the same state give the JAX
package's losses (rtol 1e-5), moments (atol 1e-6: sums of squared
gradients, f32 MLP products in another order) and parameters (atol
1e-5, as in the Adam parity test: Adagrad's first step,
lr * g / (|g| + eps), turns a rounding difference dg of a gradient near
eps into a step difference of up to lr / (4 eps) * dg, 12,500 * dg at
lr 0.05).  The JAX package
runs its row update as the Pallas kernel in interpret mode
(FLAGS_pallas_force, with FLAGS_pallas_embedding_min_rows lowered under
TINY's 100 rows; both restored afterwards).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.models import wide_deep as jwd

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import wide_deep as twd
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common

STEPS = 3
BATCH = 32


def _restore_jax_flags():
    j_set_flags({k: v for k, v in J_DEFAULTS.items()
                 if k.startswith('FLAGS_pallas_')})


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = tflags.get_flags(['FLAGS_torch_emb_update'])
    yield
    _restore_jax_flags()
    tflags.set_flags(saved)


def _build(fluid, wd, cfg=None, lr=0.05):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, preds, loss = wd.build(cfg or wd.TINY)
        fluid.optimizer.Adagrad(lr, epsilon=1e-6).minimize(loss)
    return main, startup, loss, preds


def _same_block(jprog, tprog):
    jb, tb = jprog.to_dict()['blocks'][0], tprog.to_dict()['blocks'][0]
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    for jo, to in zip(jb['ops'], tb['ops']):
        assert (jo['inputs'], jo['outputs']) == \
            (to['inputs'], to['outputs']), jo['type']
        strip = ('__op_callstack__',)
        assert {k: v for k, v in jo['attrs'].items() if k not in strip} == \
            {k: v for k, v in to['attrs'].items() if k not in strip}, \
            jo['type']
    jv = {v['name']: (tuple(v['shape']), v['persistable'],
                      v['stop_gradient']) for v in jb['vars']}
    tv = {v['name']: (tuple(v['shape']), v['persistable'],
                      v['stop_gradient']) for v in tb['vars']}
    assert jv == tv


def test_config_and_batch_match_jax():
    for name in ('BASE', 'TINY'):
        j, t = getattr(jwd, name), getattr(twd, name)
        assert vars(j) == vars(t), name
    assert twd.BASE.embedding_size == 16 and twd.BASE.hidden == (400,) * 3
    jb = jwd.synthetic_batch(jwd.TINY, 8, np.random.RandomState(3))
    tb = twd.synthetic_batch(twd.TINY, 8, np.random.RandomState(3))
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])


def test_program_equals_jax_op_for_op():
    jmain, jstart, _, _ = _build(jfluid, jwd)
    tmain, tstart, _, _ = _build(tfluid, twd)
    _same_block(jmain, tmain)
    _same_block(jstart, tstart)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('fused_emb_update') == 2
    assert 'lookup_table_v2_grad' not in types
    # TINY: the two tables, 2 hidden fc layers, the logit fc and the
    # wide part's dense fc
    assert types.count('adagrad') == len(tmain.all_parameters()) - 2 == 7
    fused = [op for op in tmain.global_block().ops
             if op.type == 'fused_emb_update']
    assert sorted(op.inputs['Param'][0] for op in fused) == \
        ['deep_embedding', 'wide_embedding']
    # each reads its lookup's output gradient and ids
    lookups = [op.outputs['Out'][0] for op in tmain.global_block().ops
               if op.type == 'lookup_table_v2']
    assert sorted(op.inputs['Grad'][0] for op in fused) == \
        sorted(tmain._grad_name_map[n] for n in lookups)
    assert all(op.inputs['Ids'] == ['sparse_input'] for op in fused)


def test_flag_off_keeps_the_dense_pair_as_jax_does():
    tflags.set_flags({'FLAGS_torch_emb_update': False})
    j_set_flags({'FLAGS_pallas_embedding': False})
    jmain, _, _, _ = _build(jfluid, jwd)
    tmain, _, _, _ = _build(tfluid, twd)
    _same_block(jmain, tmain)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count('lookup_table_v2_grad') == 2
    assert 'fused_emb_update' not in types and types.count('adagrad') == 9


def _two_lookups_of_one_table(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        a = fluid.layers.data('a', shape=[3], dtype='int64')
        b = fluid.layers.data('b', shape=[3], dtype='int64')
        attr = fluid.ParamAttr(name='shared')
        ea = fluid.layers.embedding(a, size=[600, 4], param_attr=attr,
                                    padding_idx=0)
        eb = fluid.layers.embedding(b, size=[600, 4], param_attr=attr)
        c = fluid.layers.embedding(b, size=[600, 4], padding_idx=5)
        loss = fluid.layers.mean(fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(ea, eb), c))
        fluid.optimizer.Adagrad(0.1).minimize(loss)
    return main


def test_rewrite_checks_the_grad_topology_and_keeps_padding_idx():
    """A table two lookups read gets its gradient from a sum op: no
    rewrite, as in the JAX package.  A table one lookup reads is
    rewritten, its padding_idx carried over."""
    jmain = _two_lookups_of_one_table(jfluid)
    tmain = _two_lookups_of_one_table(tfluid)
    _same_block(jmain, tmain)
    ops = tmain.global_block().ops
    fused = [op for op in ops if op.type == 'fused_emb_update']
    assert len(fused) == 1 and fused[0].attrs['padding_idx'] == 5
    assert [op.inputs['Param'][0] for op in ops
            if op.type == 'adagrad'] == ['shared']


@pytest.fixture(scope='module')
def runs():
    batch = twd.synthetic_batch(twd.TINY, BATCH, np.random.RandomState(0))
    jmain, jstart, jloss, _ = _build(jfluid, jwd)
    tmain, tstart, tloss, _ = _build(tfluid, twd)
    names = weights.startup_names(tstart)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    j_set_flags({'FLAGS_pallas_force': True,
                 'FLAGS_pallas_embedding_min_rows': 1})
    try:
        with jfluid.scope_guard(jscope):
            jexe.run(jstart)
            state = {n: np.asarray(jscope.find_var(n)) for n in names}
            jlosses = [float(jexe.run(jmain, feed=batch,
                                      fetch_list=[jloss])[0])
                       for _ in range(STEPS)]
            jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    finally:
        _restore_jax_flags()
    before = {k: common.launches(k) for k in common.KERNELS}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe.run(tstart)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(), tstart)
        tlosses = [float(texe.run(tmain, feed=batch, fetch_list=[tloss])[0])
                   for _ in range(STEPS)]
        tfinal = {n: tscope.find_var(n).clone() for n in names}
    return dict(state=state, jlosses=jlosses, tlosses=tlosses,
                jfinal=jfinal, tfinal=tfinal, tmain=tmain, tloss=tloss,
                batch=batch, launched={k: common.launches(k) - before[k]
                                       for k in common.KERNELS})


def test_three_steps_match_jax_losses(runs):
    np.testing.assert_allclose(runs['tlosses'], runs['jlosses'], rtol=1e-5)
    assert runs['tlosses'][-1] < runs['tlosses'][0]


def test_parameters_and_moments_match_jax(runs):
    assert len(runs['state']) == 2 * 9 + 1  # params, moments, lr
    for n in runs['state']:
        atol = 1e-6 if '_moment_' in n else 1e-5
        np.testing.assert_allclose(runs['tfinal'][n].numpy(),
                                   runs['jfinal'][n], atol=atol, rtol=0,
                                   err_msg=n)
    # only the looked-up rows of the tables moved
    ids = set(runs['batch']['sparse_input'].ravel().tolist())
    for table in ('deep_embedding', 'wide_embedding'):
        moved = np.any(runs['tfinal'][table].numpy() !=
                       runs['state'][table], axis=1)
        assert set(np.nonzero(moved)[0].tolist()) == ids, table


def test_step_takes_the_per_op_grad_path(runs):
    """fused_emb_update reads a lookup's output gradient, an
    intermediate, so one autograd pass to the parameters cannot stand
    in for the grad ops: the step runs them one by one, as the JAX
    executor does.  On the CPU nothing launches."""
    main, loss = runs['tmain'], runs['tloss']
    ops = [op for op in main.global_block().ops
           if op.type not in tregistry.HOST_OPS]
    assert texecutor._wpg_partition(ops, main, [loss.name]) is None
    assert runs['launched'] == {k: 0 for k in common.KERNELS}
    for v in runs['tfinal'].values():
        assert isinstance(v, torch.Tensor) and not v.requires_grad

"""BERT pretraining with LAMB, a warmup over a polynomial decay and
global-norm gradient clipping: the port against the JAX package, on the
CPU.  The small BERT of tests/test_torch_train_parity.py (2 layers,
hidden 64, 4 heads, vocab 1000, seq 64, flash_min_len 0, hidden dropout
0, attention dropout 0.1) with

    lr = linear_lr_warmup(polynomial_decay(1e-3, 10, 0.0), 2, 0.0, 1e-3)
    Lamb(lr, lamb_weight_decay=0.01, epsilon=1e-6,
         grad_clip=GradientClipByGlobalNorm(1.0))

takes 3 steps in both packages on the same feeds from the same state
(the JAX package's startup values, the step counter included).  The
JAX package runs its fused LAMB as the Pallas kernels in interpret mode
(FLAGS_pallas_force, restored afterwards), so the port's plain K5 is
held to the kernel the TPU runs.

Tolerances, and why: the per-step loss agrees to rtol 1e-5, as in the
Adam parity test (f32 through 2 layers in other summation orders).  The
rates are the same f32 expressions: rtol 1e-6.  LAMB moves each tensor
by lr * trust * r, with |lr * trust * r| <= lr * ||p|| per tensor, at
most 1.8e-3 of a parameter's norm over these steps; the parameters
agree to atol 1e-5 (the measured difference is ~6e-7), the first
moments to atol 1e-6 and the second to atol 1e-8, as in the Adam test.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.models import bert as jbert

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common

SEQ = 64
STEPS = 3
PEAK = 1e-3


def _cfg(bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.0, attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _build(fluid, bert_mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(_cfg(bert_mod), seq_len=SEQ)
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(PEAK, 10, 0.0), 2, 0.0, PEAK)
        fluid.optimizer.Lamb(
            lr, lamb_weight_decay=0.01, epsilon=1e-6,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)
        ).minimize(loss)
    # the global-norm clip's scale: clip_norm / max(||g||, clip_norm)
    scale = [op for op in main.global_block().ops
             if op.type == 'elementwise_div'][-1].outputs['Out'][0]
    return main, startup, loss, lr, scale


@pytest.fixture(scope='module')
def runs():
    batch = tbert.synthetic_batch(_cfg(tbert), 4, SEQ,
                                  np.random.RandomState(0))
    jmain, jstartup, jloss, jlr, jscale = _build(jfluid, jbert)
    tmain, tstartup, tloss, tlr, tscale = _build(tfluid, tbert)
    names = weights.startup_names(tstartup)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    j_set_flags({'FLAGS_pallas_force': True})
    try:
        with jfluid.scope_guard(jscope):
            jexe.run(jstartup)
            state = {n: np.asarray(jscope.find_var(n)) for n in names}
            jout = [jexe.run(jmain, feed=batch,
                             fetch_list=[jloss, jlr, jscale])
                    for _ in range(STEPS)]
            jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    finally:
        j_set_flags({k: v for k, v in J_DEFAULTS.items()
                     if k.startswith('FLAGS_pallas_')})
    before = {k: common.launches(k) for k in common.KERNELS}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe.run(tstartup)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(),
                                  tstartup)
        tout = [texe.run(tmain, feed=batch, fetch_list=[tloss, tlr, tscale])
                for _ in range(STEPS)]
        tfinal = {n: tscope.find_var(n).clone() for n in names}
    return dict(jmain=jmain, tmain=tmain, jstartup=jstartup,
                tstartup=tstartup, tloss=tloss, state=state,
                jout=[[np.asarray(x).reshape(-1)[0] for x in o]
                      for o in jout],
                tout=[[np.asarray(x).reshape(-1)[0] for x in o]
                      for o in tout],
                jfinal=jfinal, tfinal=tfinal,
                launched={k: common.launches(k) - before[k]
                          for k in common.KERNELS})


def test_program_serializes_like_jax(runs):
    for jp, tp in ((runs['jmain'], runs['tmain']),
                   (runs['jstartup'], runs['tstartup'])):
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
        assert sorted(v['name'] for v in jb['vars']) == \
            sorted(v['name'] for v in tb['vars'])
    types = [op.type for op in runs['tmain'].global_block().ops]
    n_params = len(runs['tmain'].all_parameters())
    assert types.count('lamb') == types.count('squared_l2_norm') == n_params
    for t in ('increment', 'elementwise_min', 'pow', 'less_than', 'cast',
              'sqrt', 'elementwise_max', 'elementwise_div'):
        assert t in types, t


def test_losses_match_every_step(runs):
    t = [o[0] for o in runs['tout']]
    j = [o[0] for o in runs['jout']]
    np.testing.assert_allclose(t, j, rtol=1e-5)
    assert all(np.isfinite(t))


def test_rates_follow_the_warmup(runs):
    """Step 0 of the counter is the first run: lr 0, then half the
    peak, then the peak times the (barely started) decay."""
    t = [o[1] for o in runs['tout']]
    np.testing.assert_allclose(t, [o[1] for o in runs['jout']], rtol=1e-6)
    np.testing.assert_allclose(t, [0.0, PEAK / 2, PEAK * 0.8], rtol=1e-6)


def test_global_norm_clip_scale_matches(runs):
    t = [o[2] for o in runs['tout']]
    np.testing.assert_allclose(t, [o[2] for o in runs['jout']], rtol=1e-5)
    assert all(0.0 < s <= 1.0 for s in t)
    assert min(t) < 1.0, 'the clip never acted: raise the test gradients'


def test_parameters_match_after_three_steps(runs):
    params = [p.name for p in runs['tmain'].all_parameters()]
    assert len(params) == 33
    for n in params:
        np.testing.assert_allclose(runs['tfinal'][n].numpy(),
                                   runs['jfinal'][n], atol=1e-5, rtol=0,
                                   err_msg=n)
        # step 1 runs at lr 0; steps 2 and 3 move every tensor
        assert not np.array_equal(runs['tfinal'][n].numpy(),
                                  runs['state'][n]), n


def test_moments_beta_powers_and_counter_match(runs):
    for n in runs['state']:
        want = runs['jfinal'][n]
        got = runs['tfinal'][n].numpy()
        if '_moment1_' in n or '_moment2_' in n:
            atol = 1e-6 if '_moment1_' in n else 1e-8
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                       err_msg=n)
        elif '_pow_acc_' in n:
            beta = 0.9 if 'beta1' in n else 0.999
            np.testing.assert_allclose(got, want, rtol=1e-7, err_msg=n)
            np.testing.assert_allclose(got, [beta ** STEPS], rtol=1e-6)
    assert runs['tfinal']['@LR_DECAY_COUNTER@'].tolist() == [float(STEPS)]
    assert runs['jfinal']['@LR_DECAY_COUNTER@'].tolist() == [float(STEPS)]


def test_step_is_one_autograd_pass_and_one_lamb_run(runs):
    """The backward is the whole-program autograd pass (the schedule and
    the clip sit outside it), and every lamb op of the step is one fused
    run: on the CPU it takes the plain versions, launching nothing."""
    main, loss = runs['tmain'], runs['tloss']
    ops = [op for op in main.global_block().ops
           if op.type not in tregistry.HOST_OPS]
    assert texecutor._wpg_partition(ops, main, [loss.name]) is not None
    first = [op.type for op in ops].index('lamb')
    run = texecutor._fused_opt_run(ops, first)
    assert len(run) == len(main.all_parameters()) == len(ops) - first
    assert runs['launched'] == {k: 0 for k in common.KERNELS}


def test_updated_state_is_plain_tensors(runs):
    for n, v in runs['tfinal'].items():
        assert isinstance(v, torch.Tensor) and not v.requires_grad, n

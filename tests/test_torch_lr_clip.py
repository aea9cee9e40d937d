"""The port's learning-rate schedules, gradient clipping and
regularizers against the JAX package's, on the CPU.

- Every schedule of fluid.layers.learning_rate_scheduler builds the
  same ops in both packages, and over 12 runs (the step counter is 0 on
  the first) gives the same rates, rtol 1e-6 (f32 pow / exp / cos in
  two libraries) and atol 1e-8, a ten-millionth of the peak rates: XLA
  contracts a scale op's multiply-add into one FMA where PyTorch rounds
  the product first, so a polynomial decay that reaches 0.0 exactly in
  the port ends at -1.5e-9 in the JAX package (10 * f32(0.1) is 1.0
  once rounded, 1 + 1.5e-9 inside an FMA).
- Each clip (by value, by norm, by global norm, through the optimizer's
  grad_clip or set_gradient_clip) and each regularizer (L1, L2, through
  the optimizer or a ParamAttr) builds the same program in both
  packages, and one Adam step from the same state gives the same
  gradients as the update ops read them (atol 1e-6 of values up to ~1:
  an MLP's f32 products in another order) and the same parameters
  (atol 1e-6).

The JAX package's global programs and names are left as they were:
each build runs inside its own unique_name.guard and program_guard.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights

SCHEDULES = {
    'noam': lambda L: L.noam_decay(64, 4, learning_rate=2.0),
    'exponential_staircase': lambda L: L.exponential_decay(
        0.1, 3, 0.5, staircase=True),
    'natural_exp': lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    'inverse_time_staircase': lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    'polynomial_power2': lambda L: L.polynomial_decay(0.1, 8, 1e-3,
                                                      power=2.0),
    'piecewise': lambda L: L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
    'cosine': lambda L: L.cosine_decay(0.1, 2, 6),
    'warmup_over_polynomial': lambda L: L.linear_lr_warmup(
        L.polynomial_decay(0.1, 10, 0.0), 4, 0.0, 0.1),
}


def _same_ops(jprog, tprog):
    jb, tb = jprog.to_dict()['blocks'][0], tprog.to_dict()['blocks'][0]
    assert [o['type'] for o in jb['ops']] == [o['type'] for o in tb['ops']]
    for jo, to in zip(jb['ops'], tb['ops']):
        assert jo['inputs'] == to['inputs'], jo['type']
        assert jo['outputs'] == to['outputs'], jo['type']
        strip = ('__op_callstack__',)
        assert {k: v for k, v in jo['attrs'].items() if k not in strip} == \
            {k: v for k, v in to['attrs'].items() if k not in strip}, \
            jo['type']
    jv = {v['name']: (tuple(v['shape']), v['persistable'])
          for v in jb['vars']}
    tv = {v['name']: (tuple(v['shape']), v['persistable'])
          for v in tb['vars']}
    assert jv == tv


def _schedule_program(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        lr = SCHEDULES[name](fluid.layers)
    return main, startup, lr


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_jax_over_12_steps(name):
    jmain, jstart, jlr = _schedule_program(jfluid, name)
    tmain, tstart, tlr = _schedule_program(tfluid, name)
    _same_ops(jmain, tmain)
    _same_ops(jstart, tstart)
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), \
        tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        jexe.run(jstart)
        want = [float(np.asarray(jexe.run(jmain, fetch_list=[jlr])[0]
                                 ).reshape(-1)[0]) for _ in range(12)]
    with tfluid.scope_guard(tfluid.Scope()):
        texe.run(tstart)
        got = [float(np.asarray(texe.run(tmain, fetch_list=[tlr])[0]
                                ).reshape(-1)[0]) for _ in range(12)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    assert np.all(np.isfinite(got))
    assert len(set(got)) > 1, 'the rate never changed over 12 steps'


def test_schedule_step_counter_is_zero_on_the_first_run():
    main, startup, lr = _schedule_program(tfluid, 'polynomial_power2')
    counter = main._lr_step_var
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        steps = [float(exe.run(main, fetch_list=[counter, lr])[0][0])
                 for _ in range(3)]
    assert steps == [0.0, 1.0, 2.0]


CLIPS = ['by_value', 'by_norm', 'global_norm', 'set_gradient_clip', 'l1',
         'l2_param_attr']


def _mlp(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 13
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[6], dtype='float32')
        attr = fluid.ParamAttr(
            regularizer=fluid.regularizer.L2Decay(0.05)) \
            if case == 'l2_param_attr' else None
        h = fluid.layers.fc(x, size=8, act='relu', param_attr=attr)
        loss = fluid.layers.mean(fluid.layers.fc(h, size=3))
        kw = {}
        if case == 'by_value':
            kw['grad_clip'] = fluid.clip.GradientClipByValue(0.05)
        elif case == 'by_norm':
            kw['grad_clip'] = fluid.clip.GradientClipByNorm(0.1)
        elif case == 'global_norm':
            kw['grad_clip'] = fluid.clip.GradientClipByGlobalNorm(0.2)
        elif case == 'set_gradient_clip':
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(0.2),
                param_list=['fc_0.w_0', 'fc_1.w_0'])
        elif case == 'l1':
            kw['regularization'] = fluid.regularizer.L1Decay(0.01)
        try:
            fluid.optimizer.Adam(0.01, epsilon=1e-6, **kw).minimize(loss)
        finally:
            # a module-level table keyed by id(program) in both packages
            fluid.clip._clip_attr.pop(id(main), None)
    grads = [op.inputs['Grad'][0] for op in main.global_block().ops
             if op.type == 'adam']
    return main, startup, loss, grads


@pytest.mark.parametrize('case', CLIPS)
def test_clip_and_regularizer_match_jax(case):
    jmain, jstart, jloss, jgrads = _mlp(jfluid, case)
    tmain, tstart, tloss, tgrads = _mlp(tfluid, case)
    _same_ops(jmain, tmain)
    _same_ops(jstart, tstart)
    assert tgrads == jgrads and len(tgrads) == 4
    names = weights.startup_names(tstart)
    feed = {'x': np.random.RandomState(1).randn(5, 6).astype('float32')}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        state = {n: np.asarray(jscope.find_var(n)) for n in names}
        want = jexe.run(jmain, feed=feed, fetch_list=[jloss] + jgrads)
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe.run(tstart)
        weights.load_numpy_params(tscope, state, tfluid.CPUPlace(), tstart)
        got = texe.run(tmain, feed=feed, fetch_list=[tloss] + tgrads)
        tfinal = {n: tscope.find_var(n).numpy() for n in names}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for n, g, w in zip(tgrads, got[1:], want[1:]):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0,
                                   err_msg=n)
    if case == 'by_value':
        assert max(np.abs(g).max() for g in got[1:]) <= 0.05
    for n in names:
        np.testing.assert_allclose(tfinal[n], jfinal[n], atol=1e-6, rtol=0,
                                   err_msg=n)

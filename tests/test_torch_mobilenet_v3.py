"""MobileNetV3-Large (models/mobilenet_v3.py) on the CPU against the JAX
package.

- BASE builds at the paper's widths: 5.4M +- 2% trainable parameters at
  1000 classes (Table 3), 15 depthwise convolutions (3 x 3 and 5 x 5,
  five of stride 2 counting the stem's plain one aside), 8 SE gates
  whose hard_sigmoid has slope 1/6 and offset 0.5, 176 rmsprop updates
  and an EMA of every trainable parameter.
- TINY builds the same training program and startup program in both
  packages (same_program), and trains 3 steps of RMSProp + L2 decay +
  EMA in lockstep: before each step the port takes the JAX package's
  whole state, then the loss and every state variable (parameters,
  batch_norm moving statistics, RMSProp's moment / mean square / mean
  gradient, the EMA variables, the learning-rate counter) agree within
  rtol TOL = 1e-5 plus 1e-5 of the largest magnitude among the
  variables of its kind (``_kind``: the parameters and statistics, each
  accumulator, the EMA).  Of its kind, not of itself: a batch_norm
  scale whose gradient cancels to ~1e-4 of the others' carries the
  others' absolute rounding (its mean square differed by 1.5% of
  itself at 9e-14, against others near 1e-8).  TINY's
  lockstep runs at dropout 0 (the op still runs, keeping every
  element): the port's dropout draws from its counter hash, not jax
  threefry.
- The for_test clone of TINY gives the JAX package's logits from the
  same state within TOL.
"""

import numpy as np

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import mobilenet_v3 as mnv3

from torch_attention_cases import close
from torch_program_cases import build_both, same_program

TOL = 1e-5
TINY = mnv3.TINY._replace(dropout=0.0)


def _kind(name):
    for acc in ('_momentum_', '_mean_square_', '_mean_grad_'):
        if acc in name:
            return acc
    return '.ema' if name.endswith('.ema') else 'state'


def _train(fluid):
    _, _, loss, logits = mnv3.build_train(fluid, TINY)
    return loss, logits


def test_base_has_the_papers_widths():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, _, loss, logits = mnv3.build_train(tfluid, mnv3.BASE)
    n = mnv3.count_parameters(main)
    assert abs(n - 5.4e6) <= 0.02 * 5.4e6, n
    assert tuple(logits.shape) == (-1, 1000)
    ops = main.global_block().ops
    types = [op.type for op in ops]
    dw = [op for op in ops if op.type == 'depthwise_conv2d']
    assert len(dw) == 15
    assert sorted(set(tuple(op.input('Filter') and
                            main.global_block().var(op.input('Filter')[0])
                            .shape[2:]) for op in dw)) == [(3, 3), (5, 5)]
    assert sum(op.attrs['strides'] == [2, 2] for op in dw) == 4
    gates = [op for op in ops if op.type == 'hard_sigmoid']
    assert len(gates) == 8
    assert all(op.attrs['slope'] == 1.0 / 6 and op.attrs['offset'] == 0.5
               for op in gates)
    assert types.count('rmsprop') == len(main.global_block()
                                         .all_parameters()) - 2 * 47
    assert types.count('dropout') == 1
    names = weights.startup_names(startup)
    assert sum(n.endswith('.ema') for n in names) == types.count('rmsprop')


def test_tiny_serializes_and_trains_like_jax():
    progs = build_both(_train, seed=5)
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])
    jm, js, (jl, _) = progs['jax']
    tm, ts, (tl, _) = progs['torch']
    names = weights.startup_names(ts)
    assert any(n.endswith('.ema') for n in names)
    assert any('_mean_square' in n for n in names)
    rng = np.random.RandomState(0)
    feeds = [mnv3.synthetic_batch(TINY, rng) for _ in range(3)]
    steps = []
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        for feed in feeds:
            before = weights.numpy_state(jfluid.global_scope(), names)
            loss, = exe.run(jm, feed=feed, fetch_list=[jl])
            steps.append((before, np.asarray(loss), weights.numpy_state(
                jfluid.global_scope(), names)))
    place = tfluid.CPUPlace()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(place)
        exe.run(ts)
        for k, (feed, (before, want, want_state)) in enumerate(
                zip(feeds, steps)):
            weights.load_numpy_params(tfluid.global_scope(), before, place,
                                      ts)
            loss, = exe.run(tm, feed=feed, fetch_list=[tl])
            close(np.asarray(loss).reshape(want.shape), want, TOL,
                  'step %d loss' % k)
            got = weights.numpy_state(tfluid.global_scope(), names)
            scale = {}
            for n in names:
                w = np.abs(want_state[n]).max(initial=0.0)
                scale[_kind(n)] = max(scale.get(_kind(n), 0.0), float(w))
            for n in names:
                np.testing.assert_allclose(
                    got[n].reshape(want_state[n].shape), want_state[n],
                    rtol=TOL, atol=TOL * scale[_kind(n)],
                    err_msg='step %d %s' % (k, n))
        # the steps moved the EMA off its zero start
        assert all(np.abs(got[n]).max() > 0 for n in names
                   if n.endswith('.ema'))


def test_tiny_eval_clone_matches_jax():
    progs = build_both(_train, seed=5)
    feed = mnv3.synthetic_batch(TINY, np.random.RandomState(4))
    out = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup, (_, logits) = progs[key]
        test = main.clone(for_test=True)
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            if key == 'jax':
                state = weights.numpy_state(
                    fluid.global_scope(),
                    weights.startup_names(progs['torch'][1]))
            else:
                weights.load_numpy_params(fluid.global_scope(), state,
                                          fluid.CPUPlace(),
                                          progs['torch'][1])
            out[key], = exe.run(test, feed=feed, fetch_list=[logits])
    close(np.asarray(out['torch']), np.asarray(out['jax']), TOL, 'logits')

"""ResNet under mixed precision against the JAX package, on the CPU:
ResNet-50's stem (7 x 7 convolution, batch norm, max pool) and its
first bottleneck block with the projection shortcut, global average
pooling and a 10-class fc, at 32 x 32 in NHWC (the layout bench.py's
ResNet-50 trains in), batch 2, under decorate(Momentum(0.1, 0.9)) with
dynamic loss scaling.  (Deeper nets at this size bring the last stage
to 1 x 1 pixels, where batch norm normalizes each channel over the 2-4
values of the batch: two bf16 roundings of its inputs then move its
output by tens of percent in either package.  Here every batch norm
sees 128 values a channel or more.)

Step 1 runs in both packages from the JAX package's startup values on
the same batch (lockstep's first step; tests/torch_image_cases.py): the
convolutions and the fc product in bf16 with f32 accumulation, batch
norm with f32 statistics and a bf16 output, relu, pooling and the
residual adds following their bf16 inputs, the loss in f32.

Tolerances, and why: both packages round every convolution, batch norm
and add to bf16 (2^-8 relative), in other summation orders, and a relu
input within bf16 rounding of 0 may fall on either side (the relu
flips tests/torch_image_cases.py describes, far likelier than in f32);
at batch 2 the batch norms' backward
cancels heavily, so the JAX package's own bf16 gradients lie 7-20% (in
norm) from its f32 gradients of the same step.  So the gradients are
held to the f32 reference as the JAX package's are: each velocity
(Momentum's step-1 velocity is the unscaled gradient) within 1.5 times
the JAX package's bf16 distance from the f32 velocity plus 1e-2, in
norm.  The loss within rel 1e-2 of the JAX package's bf16 loss; the
moving means and variances within 1e-2 of their largest (f32 statistics
of bf16 inputs); the loss scale and its counters exact.
"""

import numpy as np

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import resnet as tresnet

BATCH = 2
BF16_FACTOR = 1.5
BF16_SLACK = 1e-2
STAT_TOL_OF_MAX = 1e-2
LOSS_RTOL = 1e-2


def _build(fluid, resnet, amp=True):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data('image', shape=[32, 32, 3])
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        conv = resnet.conv_bn_layer(img, 64, 7, stride=2, act='relu',
                                    data_format='NHWC')
        conv = fluid.layers.pool2d(conv, pool_size=3, pool_stride=2,
                                   pool_padding=1, pool_type='max',
                                   data_format='NHWC')
        conv = resnet.bottleneck_block(conv, 64, 1, False, 'NHWC')
        pool = fluid.layers.pool2d(conv, pool_type='avg', pool_size=1,
                                   global_pooling=True, data_format='NHWC')
        logits = fluid.layers.fc(pool, size=10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.Momentum(0.1, momentum=0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    return main, startup, loss


def _rel(got, want):
    return float(np.linalg.norm((got - want).astype(np.float64)) /
                 max(np.linalg.norm(want.astype(np.float64)), 1e-30))


def _jax_step(main, startup, loss, state, feed):
    """(loss, state after) of one JAX package step from `state`."""
    import jax.numpy as jnp
    names = sorted(state)
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for n in names:
            jfluid.global_scope().set_var(n, jnp.asarray(state[n]))
        out = float(np.asarray(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0]))
        return out, weights.numpy_state(jfluid.global_scope(), names)


def test_resnet50_bottleneck_amp_step1_matches_jax():
    rng = np.random.RandomState(3)
    feed = {'image': rng.rand(BATCH, 32, 32, 3).astype('float32'),
            'label': rng.randint(0, 10, (BATCH, 1)).astype('int64')}
    jm, js, jl = _build(jfluid, jresnet)
    tm, ts, tl = _build(tfluid, tresnet)
    names = weights.startup_names(ts)
    with jfluid.scope_guard(jfluid.Scope()):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
        before = weights.numpy_state(jfluid.global_scope(), names)
    jloss, after = _jax_step(jm, js, jl, before, feed)
    f32 = [n for n in names if '_steps_' not in n and n != 'loss_scaling_0']
    _, ref = _jax_step(*_build(jfluid, jresnet, amp=False),
                       {n: before[n] for n in f32}, feed)
    conv_out = [op.output('Output')[0] for op in tm.global_block().ops
                if op.type == 'conv2d'][0]
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tfluid.global_scope(), before,
                                  tfluid.CPUPlace(), ts)
        tloss, act = texe.run(tm, feed=feed, fetch_list=[tl, conv_out],
                              return_numpy=False)
        got = weights.numpy_state(tfluid.global_scope(), names)
        dtypes = {n: tfluid.global_scope().find_var(n).dtype for n in f32}
    assert act.dtype == torch.bfloat16 and tloss.dtype == torch.float32
    assert set(dtypes.values()) == {torch.float32}
    assert np.isfinite(float(tloss))
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    for n in ('loss_scaling_0', 'good_steps_0', 'bad_steps_0'):
        np.testing.assert_array_equal(got[n], after[n], n)
    stats = [n for n in f32 if 'batch_norm' in n and
             n.endswith(('.w_2', '.w_3'))]
    velocities = [n for n in f32 if '_velocity_' in n]
    assert len(stats) == 2 * 5 and len(velocities) == 5 * 3 + 2
    for n in stats:
        w = after[n]
        assert float(np.abs(got[n] - w).max()) <= \
            STAT_TOL_OF_MAX * float(np.abs(w).max()), n
    for n in velocities:
        limit = BF16_FACTOR * _rel(after[n], ref[n]) + BF16_SLACK
        assert _rel(got[n], ref[n]) <= limit, (n, _rel(got[n], ref[n]),
                                               limit)

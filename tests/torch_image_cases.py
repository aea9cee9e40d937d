"""Shared checks of the image-classification slice's tests, on the
CPU.

One op: its forward and gradient through the JAX registry's lowering
(its grad op is jax.vjp over it) and through the port's (torch.autograd
over it), from the same numpy inputs and cotangents.  Both sides
compute in f32, in other summation orders (XLA's fused loops against
PyTorch's CPU kernels), so a forward output agrees to rtol 1e-5 with an
absolute floor of 1e-5 of the output's largest magnitude (for values
that cancel to near 0), and a gradient to within 1e-4 of its largest
magnitude.

A training program (``lockstep``): both packages train from the JAX
package's startup values on the same batches, and before every step
the port takes the JAX package's whole state (parameters, moving means
and variances, velocities, the learning rate; weights.numpy_state of
the JAX scope), so each step is compared from the same state.  After
the step: the loss within rel 1e-4; the moving means and variances
within 1e-4 of their largest magnitude; the velocities within 1e-2 of
theirs; each parameter within 1e-4 of its largest magnitude plus the
learning rate times its velocity's bound (Momentum moves it by lr *
velocity, so a parameter that starts at 0 is its velocity scaled).
Why the velocities get 1e-2: a velocity is the step's gradient (plus mu
times the same old velocity on both sides), and a gradient is not
continuous at a relu.  Where a relu input lies within f32 rounding of 0
(about 1e-6 in these nets), two correct f32 implementations can put it
on either side: ResNet-18 at 32 x 32 has one such element at step 2 (a
stage-3 batch_norm output 1.6e-6 from 0 in float64, negative in the
port's f32 forward and positive in the JAX package's, while both
forwards stay within 1e-5 of float64), which moves the velocities of
the layers behind it by up to 7e-3 of their largest.  A free run of the
port (its own state from the startup values on) gives the JAX
package's losses within rel 1e-4 too; its state is not compared: at
batch 8 these nets are chaotic by step 3 (a 1e-4 change of the JAX
package's own step-2 state moves its step-3 velocities by tens of
percent).
"""

import numpy as np

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.ops import registry as jreg

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.ops import registry as treg

FWD_RTOL = 1e-5
FWD_ATOL_OF_MAX = 1e-5
GRAD_TOL_OF_MAX = 1e-4
LOSS_RTOL = 1e-4
STATE_TOL_OF_MAX = 1e-4
VELOCITY_TOL_OF_MAX = 1e-2


def _jax_ins(ins):
    return {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}


def _torch_ins(ins):
    return {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}


def run_jax(op, ins, attrs):
    ctx = jreg.LowerCtx(step=1, op_seed=0, prefer_test=False)
    outs = jreg.get(op).run(ctx, _jax_ins(ins), attrs)
    return {s: [np.asarray(a) for a in v] for s, v in outs.items()}


def run_torch(op, ins, attrs):
    ctx = treg.LowerCtx(step=1, op_seed=0, device='cpu')
    outs = treg.get(op).run(ctx, _torch_ins(ins), attrs)
    return {s: [a.detach().numpy() for a in v] for s, v in outs.items()}


def cotangents(op, outs, seed):
    """A seeded random cotangent for every floating output slot that
    carries a gradient."""
    rng = np.random.RandomState(seed)
    skip = treg.get(op).no_grad_out_slots
    return {'GRAD::' + s: [np.asarray(rng.randn(*np.shape(a))).astype(
        a.dtype) for a in v]
            for s, v in outs.items()
            if s not in skip and all(np.issubdtype(np.asarray(a).dtype,
                                                   np.floating) for a in v)}


def grads_jax(op, ins, attrs, cts):
    ctx = jreg.LowerCtx(step=1, op_seed=0, prefer_test=False)
    g = dict(_jax_ins(ins))
    g.update(_jax_ins(cts))
    outs = jreg.get(op + '_grad').run(ctx, g, attrs)
    return {s: [np.asarray(a) for a in v] for s, v in outs.items()}


def grads_torch(op, ins, attrs, cts):
    ctx = treg.LowerCtx(step=1, op_seed=0, device='cpu')
    g = dict(_torch_ins(ins))
    g.update(_torch_ins(cts))
    outs = treg.get(op + '_grad').run(ctx, g, attrs)
    return {s: [a.detach().numpy() for a in v] for s, v in outs.items()}


def assert_forward_close(want, got, slots=None):
    for s in slots or want:
        for w, g in zip(want[s], got[s]):
            w = np.asarray(w)
            assert w.shape == g.shape, (s, w.shape, g.shape)
            if not np.issubdtype(w.dtype, np.floating):
                np.testing.assert_array_equal(g, w, err_msg=s)
                continue
            w, g = w.astype(np.float64), g.astype(np.float64)
            atol = FWD_ATOL_OF_MAX * max(np.abs(w).max(initial=0.0), 1e-30)
            np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=atol,
                                       err_msg=s)


def assert_grads_close(want, got, ins):
    """Every floating input's gradient within GRAD_TOL_OF_MAX of its
    largest magnitude."""
    for s, vals in ins.items():
        for i, a in enumerate(vals):
            if not np.issubdtype(np.asarray(a).dtype, np.floating):
                continue
            w = np.asarray(want['GRAD::' + s][i], np.float64)
            g = np.asarray(got['GRAD::' + s][i], np.float64)
            assert w.shape == g.shape, (s, w.shape, g.shape)
            scale = max(np.abs(w).max(initial=0.0), 1e-30)
            err = np.abs(g - w).max(initial=0.0) / scale
            assert err <= GRAD_TOL_OF_MAX, (s, err)


def check_op(op, ins, attrs, seed=0, fwd_slots=None):
    """Forward and gradient of `op` in both packages; returns both
    forwards (jax, torch)."""
    want = run_jax(op, ins, attrs)
    got = run_torch(op, ins, attrs)
    assert_forward_close(want, got, fwd_slots)
    cts = cotangents(op, want, seed)
    if cts:
        assert_grads_close(grads_jax(op, ins, attrs, cts),
                           grads_torch(op, ins, attrs, cts), ins)
    return want, got


def same_block(jb, tb):
    """The two packages' serialized blocks hold the same ops (inputs,
    outputs and attributes, the creation call stack aside) and the same
    variables with their shapes and flags (int64 and int32 alike: the
    JAX package narrows int64)."""
    def norm(d):
        return 'int' if d in ('int32', 'int64') else d
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
        assert norm(v['dtype']) == norm(tv[name]['dtype']), name
        for key in ('persistable', 'is_parameter', 'is_data',
                    'stop_gradient', 'trainable'):
            assert v[key] == tv[name][key], (name, key)


def programs(build, seed=17):
    """{'jax' / 'torch': (main, startup, loss, fetches)} of
    build(fluid, resnet module, se_resnext module) in each package."""
    out = {}
    for key, fluid, mods in (('jax', jfluid, (jresnet, jse)),
                             ('torch', tfluid, (tresnet, tse))):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss, fetches = build(fluid, *mods)
        out[key] = (main, startup, loss, fetches)
    return out


def _max(a):
    return max(float(np.abs(a).max(initial=0.0)), 1e-30)


def _state_close(want, got, names, lr):
    for n in names:
        w, g = want[n].astype(np.float64), got[n].astype(np.float64)
        err = float(np.abs(g - w).max(initial=0.0))
        if '_velocity_' in n:
            limit = VELOCITY_TOL_OF_MAX * _max(w)
        elif n + '_velocity_0' in want:
            limit = STATE_TOL_OF_MAX * _max(w) + \
                lr * VELOCITY_TOL_OF_MAX * _max(want[n + '_velocity_0'])
        else:
            limit = STATE_TOL_OF_MAX * _max(w)
        assert err <= limit, (n, err, limit)


def lockstep(progs, feeds, lr):
    """Train both packages on `feeds` (see the module docstring);
    returns (the JAX package's losses, the state's names)."""
    jm, js, jl, _ = progs['jax']
    tm, ts, tl, _ = progs['torch']
    names = weights.startup_names(ts)
    jlosses, before, after = [], [], []
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        for feed in feeds:
            before.append(weights.numpy_state(jfluid.global_scope(), names))
            jlosses.append(float(np.asarray(
                jexe.run(jm, feed=feed, fetch_list=[jl])[0])))
            after.append(weights.numpy_state(jfluid.global_scope(), names))
    place = tfluid.CPUPlace()
    locked = []
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(place)
        texe.run(ts)
        for feed, b, a in zip(feeds, before, after):
            weights.load_numpy_params(tfluid.global_scope(), b, place, ts)
            locked.append(float(texe.run(tm, feed=feed, fetch_list=[tl])[0]))
            _state_close(a, weights.numpy_state(tfluid.global_scope(),
                                                names), names, lr)
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(place)
        texe.run(ts)
        weights.load_numpy_params(tfluid.global_scope(), before[0], place, ts)
        free = [float(texe.run(tm, feed=feed, fetch_list=[tl])[0])
                for feed in feeds]
    np.testing.assert_allclose(locked, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(free, jlosses, rtol=LOSS_RTOL)
    return jlosses, names


def resnet18_lockstep(layout):
    """test_models.py's ResNet-18 at 32 x 32 (batch 8, 10 classes,
    Momentum(0.01, 0.9), a new seeded batch each step), 3 steps in
    lockstep, in `layout`."""
    def build(fluid, resnet, _):
        feeds, logits, loss, acc = resnet.build(
            image_shape=(3, 32, 32), class_dim=10, depth=18,
            data_format=layout)
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
        return loss, [logits, acc]
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        x = rng.randn(8, 3, 32, 32).astype('float32')
        if layout == 'NHWC':
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        feeds.append({'image': x, 'label': rng.randint(
            0, 10, (8, 1)).astype('int64')})
    progs = programs(build)
    types = [op.type for op in progs['torch'][0].global_block().ops]
    assert types.count('conv2d') == 20 and types.count('momentum') == 62
    losses, names = lockstep(progs, feeds, 0.01)
    assert sum('_velocity_' in n for n in names) == 62
    assert np.isfinite(losses).all()


def se_resnext_tiny_build(is_test=False):
    """test_se_resnext.py's tiny SE-ResNeXt (32 x 32, 4 classes, depth 8:
    DEPTH_CFG[8] = [1, 1, 1, 1], set by the caller; cardinality 4) with
    its dropout at 0 (the hidden dropout draws from jax threefry, which
    torch does not reproduce), and Momentum(0.05, 0.9) unless is_test."""
    def build(fluid, _, se):
        _, out, loss, acc = se.build(
            image_shape=(3, 32, 32), class_dim=4, depth=8, cardinality=4,
            reduction_ratio=4, is_test=is_test,
            stage_filters=(8, 16, 16, 32))
        block = fluid.default_main_program().global_block()
        for op in block.ops:
            if op.type == 'dropout':
                op.attrs['dropout_prob'] = 0.0
        if not is_test:
            fluid.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
        return loss, [out]
    return build

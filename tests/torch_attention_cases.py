"""Shared checks of the attention-chain slice's tests (BERT at seq 128,
Transformer NMT), on the CPU.

One op (``check``): its forward and its gradient through the JAX
registry's lowering (the grad op is jax.vjp over it) and through the
port's (torch.autograd over it), from the same numpy inputs and seeded
cotangents.  Each comparison has a tolerance ``tol``: 0 is bitwise (for
ops the JAX package computes exactly: copies, views, comparisons); tol
> 0 holds every element within rtol tol plus tol times the largest
magnitude (f32 on both sides, in XLA's order against PyTorch's).

A training program (``adam_lockstep``): both packages build it, the
JAX package runs its startup program and every step from its own
state; before each step the port takes the JAX package's whole state
(weights.numpy_state), so each step is compared from the same state.
Adam's epsilon is BERT's 1e-6 there: at the default 1e-8 a gradient
that is mathematically 0 (a key projection's bias: softmax is
shift-invariant along each row) turns its rounding noise into steps of
up to lr that differ between the packages.
"""

import numpy as np

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.ops import registry as treg

from torch_image_cases import (cotangents, grads_jax, grads_torch,
                               run_jax, run_torch)

LR = 1e-3
EPSILON = 1e-6


def close(got, want, tol, what=''):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (what, got.dtype, want.dtype)
    if tol == 0 or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def check(op, ins, attrs, tol, grad_tol=None, seed=0):
    """Forward of `op` in both packages within `tol`, and the gradient
    of every floating input within `grad_tol` (default `tol`) when the
    op has a floating output that carries one."""
    want, got = run_jax(op, ins, attrs), run_torch(op, ins, attrs)
    assert got.keys() == want.keys()
    for s in want:
        assert len(got[s]) == len(want[s]), s
        for g, w in zip(got[s], want[s]):
            close(g, w, tol, s)
    cts = cotangents(op, want, seed)
    if not cts:
        return
    gj = grads_jax(op, ins, attrs, cts)
    gt = grads_torch(op, ins, attrs, cts)
    for s, vals in ins.items():
        for i, a in enumerate(vals):
            if np.issubdtype(np.asarray(a).dtype, np.floating):
                close(gt['GRAD::' + s][i], gj['GRAD::' + s][i],
                      tol if grad_tol is None else grad_tol, 'GRAD::' + s)


def programs(build, jax_mod, torch_mod, seed=5):
    """{'jax' / 'torch': (main, startup, out)}: out = build(fluid, mod)
    with each package's fluid and model module, inside its own
    unique_name.guard and program_guard."""
    out = {}
    for key, fluid, mod in (('jax', jfluid, jax_mod),
                            ('torch', tfluid, torch_mod)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            res = build(fluid, mod)
        out[key] = (main, startup, res)
    return out


def whole_program_grad(main, loss):
    """The executor's whole-program-grad plan of a training step, or
    None where it falls to the per-op grad path."""
    ops = [op for op in main.global_block().ops
           if op.type not in treg.HOST_OPS]
    return texecutor._wpg_partition(ops, main, [loss.name])


def adam_lockstep(progs, feeds, grad_of=()):
    """Train both packages on `feeds` (see the module docstring).
    Returns per step {'jax': ..., 'torch': ...} of the loss, the
    gradients of the variables `grad_of`, and the state after the step,
    and the state's names."""
    jm, js, jl = progs['jax']
    tm, ts, tl = progs['torch']
    names = weights.startup_names(ts)
    jg = [jm._grad_name_map[n] for n in grad_of]
    tg = [tm._grad_name_map[n] for n in grad_of]
    steps = []
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        for feed in feeds:
            before = weights.numpy_state(jfluid.global_scope(), names)
            out = jexe.run(jm, feed=feed, fetch_list=[jl] + jg)
            steps.append({'before': before, 'jax': (
                float(np.asarray(out[0])), [np.asarray(g) for g in out[1:]],
                weights.numpy_state(jfluid.global_scope(), names))})
    place = tfluid.CPUPlace()
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(place)
        texe.run(ts)
        for feed, step in zip(feeds, steps):
            weights.load_numpy_params(tfluid.global_scope(), step['before'],
                                      place, ts)
            out = texe.run(tm, feed=feed, fetch_list=[tl] + tg)
            step['torch'] = (float(out[0]), list(out[1:]), weights.numpy_state(
                tfluid.global_scope(), names))
    return steps, names

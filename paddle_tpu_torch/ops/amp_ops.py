"""Mixed-precision support ops: the device side of
``fluid.contrib.mixed_precision.decorate``'s dynamic loss scaling.

Reference: python/paddle/fluid/contrib/mixed_precision/decorator.py:27
(OptimizerWithMixedPrecision), operators/amp/; the JAX package's
ops/amp_ops.py.  The whole state machine stays on the device: the
overflow verdict is a device bool that selects, elementwise, between
the unscaled gradients and zeros, and between the next scale and
counters; nothing reads it on the host, so a step never waits for the
card.
"""

import torch

from .registry import register


@register('check_finite_and_unscale', no_grad_out_slots=('FoundInfinite',))
def check_finite_and_unscale(ctx, ins, attrs):
    """FoundInfinite: one verdict over every gradient of X, true where
    any element is inf or nan (a multi-tensor max-abs pass: its maximum
    is inf or nan exactly then).  Out: each X divided by the scale, or
    zeros where the verdict is true."""
    scale = ins['Scale'][0].reshape(())
    xs = ins['X']
    if xs:
        peaks = torch._foreach_norm(xs, ord=float('inf'))
        found = ~torch.isfinite(torch.stack(peaks)).all()
    else:
        found = torch.zeros((), dtype=torch.bool, device=scale.device)
    outs = []
    for g in xs:
        u = g / scale
        outs.append(torch.where(found, torch.zeros_like(u), u))
    return {'Out': outs, 'FoundInfinite': [found]}


@register('update_loss_scaling',
          no_grad_out_slots=('LossScaling', 'OutGoodSteps', 'OutBadSteps'))
def update_loss_scaling(ctx, ins, attrs):
    """The dynamic loss-scaling state machine: after incr_every_n_steps
    good steps in a row the scale grows by incr_ratio, after
    decr_every_n_nan_or_inf bad ones it shrinks by decr_ratio (never
    below min_loss_scaling); a step that changes the scale starts its
    counter over.  The scale is [1] f32, the counters [1] int32."""
    found = ins['FoundInfinite'][0].reshape(())
    scale = ins['PrevLossScaling'][0].reshape(())
    good = ins['InGoodSteps'][0].reshape(())
    bad = ins['InBadSteps'][0].reshape(())
    incr_every = attrs.get('incr_every_n_steps', 1000)
    decr_every = attrs.get('decr_every_n_nan_or_inf', 2)
    incr_ratio = attrs.get('incr_ratio', 2.0)
    decr_ratio = attrs.get('decr_ratio', 0.5)
    zero = torch.zeros_like(good)
    good_new = torch.where(found, zero, good + 1)
    bad_new = torch.where(found, bad + 1, zero)
    do_incr = good_new >= incr_every
    do_decr = bad_new >= decr_every
    scale_new = torch.where(do_incr, scale * incr_ratio,
                            torch.where(do_decr, scale * decr_ratio, scale))
    scale_new = torch.clamp(scale_new,
                            min=float(attrs.get('min_loss_scaling', 1.0)))
    good_new = torch.where(do_incr, zero, good_new)
    bad_new = torch.where(do_decr, zero, bad_new)
    return {'LossScaling': [scale_new.reshape(1).to(torch.float32)],
            'OutGoodSteps': [good_new.reshape(1).to(torch.int32)],
            'OutBadSteps': [bad_new.reshape(1).to(torch.int32)]}

"""Learning-rate schedules as ops on a persistent step counter.

Reference: python/paddle/fluid/layers/learning_rate_scheduler.py —
noam_decay, exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup over
the @LR_DECAY_COUNTER@ autoincrement variable.  Each schedule appends
the ops the JAX package's module appends, so both packages build the
same Program; the executor runs them every step on the device, before
the optimizer reads the rate.
"""

import math

from ..framework import default_main_program, default_startup_program
from . import ops as _ops
from . import tensor as _tensor
from . import nn as _nn


def _global_step_counter():
    """Persistent float32 [1] step counter; 0 on the first run (the
    reference's @LR_DECAY_COUNTER@ autoincrement semantics)."""
    main = default_main_program()
    cached = getattr(main, '_lr_step_var', None)
    if cached is not None:
        return cached
    block = main.global_block()
    name = '@LR_DECAY_COUNTER@'
    var = block.create_var(name=name, shape=(1,), dtype='float32',
                           persistable=True)
    var.stop_gradient = True
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=(1,), dtype='float32',
                  persistable=True)
    sb.append_op('fill_constant', outputs={'Out': name},
                 attrs={'shape': [1], 'dtype': 'float32', 'value': 0.0})
    block.append_op('increment', inputs={'X': var},
                    outputs={'Out': var}, attrs={'step': 1.0},
                    infer_shape=False)
    step = _ops.scale(var, scale=1.0, bias=-1.0)
    step.stop_gradient = True
    main._lr_step_var = step
    return step


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _global_step_counter()
    a = _ops.pow(step, -0.5)
    b = _ops.scale(step, scale=warmup_steps ** -1.5)
    lr = _ops.scale(_nn.elementwise_min(a, b),
                    scale=learning_rate * d_model ** -0.5)
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = _ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _ops.floor(div)
    return _ops.scale(
        _ops.exp(_ops.scale(div, scale=math.log(decay_rate))),
        scale=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _global_step_counter()
    div = _ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _ops.floor(div)
    return _ops.scale(_ops.exp(_ops.scale(div, scale=-decay_rate)),
                      scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _global_step_counter()
    div = _ops.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = _ops.floor(div)
    denom = _ops.scale(div, scale=decay_rate, bias=1.0)
    return _ops.scale(_ops.reciprocal(denom), scale=learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    step = _global_step_counter()
    capped = _nn.elementwise_min(
        step, _tensor.fill_constant([1], 'float32', decay_steps))
    frac = _ops.scale(capped, scale=1.0 / decay_steps)
    one_minus = _ops.scale(frac, scale=-1.0, bias=1.0)
    poly = _ops.pow(one_minus, factor=power)
    return _ops.scale(poly, scale=learning_rate - end_learning_rate,
                      bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """lr = values[i] for boundaries[i-1] <= step < boundaries[i]."""
    step = _global_step_counter()
    lr = None
    for i, v in enumerate(values):
        if i == 0:
            lo_mask = None
        else:
            lo = _tensor.fill_constant([1], 'float32',
                                       float(boundaries[i - 1]))
            lo_mask = _tensor.cast(_ops.greater_equal(step, lo),
                                   'float32')
        if i < len(boundaries):
            hi = _tensor.fill_constant([1], 'float32',
                                       float(boundaries[i]))
            hi_mask = _tensor.cast(_ops.less_than(step, hi), 'float32')
        else:
            hi_mask = None
        if lo_mask is None:
            mask = hi_mask
        elif hi_mask is None:
            mask = lo_mask
        else:
            mask = _nn.elementwise_mul(lo_mask, hi_mask)
        term = _ops.scale(mask, scale=float(v))
        lr = term if lr is None else _nn.elementwise_add(lr, term)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _global_step_counter()
    epoch = _ops.floor(_ops.scale(step, scale=1.0 / step_each_epoch))
    cosv = _ops.cos(_ops.scale(epoch, scale=math.pi / epochs))
    return _ops.scale(cosv, scale=0.5 * learning_rate,
                      bias=0.5 * learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _global_step_counter()
    # warmup: start + (end-start)*step/warmup ; after: learning_rate
    frac = _ops.scale(step, scale=1.0 / warmup_steps)
    warm = _ops.scale(frac, scale=end_lr - start_lr, bias=start_lr)
    ws = _tensor.fill_constant([1], 'float32', float(warmup_steps))
    in_warm = _tensor.cast(_ops.less_than(step, ws), 'float32')
    if not hasattr(learning_rate, 'name'):
        learning_rate = _tensor.fill_constant(
            [1], 'float32', float(learning_rate))
    after = _nn.elementwise_mul(
        learning_rate, _ops.scale(in_warm, scale=-1.0, bias=1.0))
    return _nn.elementwise_add(_nn.elementwise_mul(warm, in_warm), after)

"""AMP decorator: bf16 compute with dynamic loss scaling.

Reference: python/paddle/fluid/contrib/mixed_precision/decorator.py:27
(OptimizerWithMixedPrecision, :53-69 loss scaling) and fp16_utils.py
(the black/white list program rewrite); the JAX package's
fluid/contrib/mixed_precision/decorator.py, whose program this builds op
for op.

Instead of rewriting variable dtypes and inserting cast ops, the ops
get marks that their lowerings and ``OpDef.run`` read: white ops
(``__amp__``) run their products in bf16 with f32 accumulation, gray ops
(``__amp_gray__``) follow a bf16 input, black ops (``__amp_black__``)
compute in f32.  The variables keep their declared f32 dtypes in the
IR; the master parameters and their gradients stay f32 at run time.
Loss scaling stays on the device through the check_finite_and_unscale
and update_loss_scaling ops (ops/amp_ops.py): an overflowing step hands
the optimizer zero gradients instead of branching on the host.
"""

from ... import unique_name
from ...framework import default_main_program, default_startup_program
from .fp16_lists import AutoMixedPrecisionLists


def _mark_amp_ops(program, amp_lists):
    """Mark every op of `program` by its list.  The normalizations keep
    their f32 parameters (the reference rewrite never casts their Scale,
    Bias or statistics either): their lowerings compute the statistics
    in f32 and give the input's dtype, so they follow a bf16 input
    without the gray cast.  softmax_with_cross_entropy and softmax
    compute in f32 inside; taking their bf16 inputs up would only
    double the buffer, so they skip the black cast, but the black rule's
    f32 output holds for the per-row loss (``__amp_black_out__``).  An
    explicit custom placement overrides these exemptions."""
    no_harmonize = {'batch_norm', 'layer_norm', 'instance_norm',
                    'group_norm', 'sync_batch_norm',
                    'softmax_with_cross_entropy', 'softmax'}
    no_harmonize -= getattr(amp_lists, 'custom_placed', set())
    for block in program.blocks:
        for op in block.ops:
            if op.type in amp_lists.white_list:
                op.attrs['__amp__'] = True
            elif op.type in amp_lists.gray_list - no_harmonize:
                op.attrs['__amp_gray__'] = True
            elif op.type in amp_lists.black_list - no_harmonize:
                op.attrs['__amp_black__'] = True
            elif op.type in amp_lists.black_list:
                op.attrs['__amp_black_out__'] = True
    program._bump_version()


def _make_scalar(name, dtype, value):
    """A persistable [1] variable of the main program, filled with
    `value` by the startup program."""
    main = default_main_program().global_block()
    var = main.create_var(name=name, shape=(1,), dtype=dtype,
                          persistable=True)
    var.stop_gradient = True
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=(1,), dtype=dtype, persistable=True)
    sb.append_op('fill_constant', outputs={'Out': name},
                 attrs={'shape': [1], 'dtype': dtype,
                        'value': float(value)})
    return var


class OptimizerWithMixedPrecision(object):
    """Reference decorator.py:27.  ``backward`` marks the program, scales
    the loss by the persistable loss scale and differentiates the scaled
    loss; ``apply_gradients`` unscales the gradients on the device
    (zeros on an overflow), updates the scale and its good and bad
    counters (with dynamic scaling) and hands the unscaled gradients to
    the decorated optimizer."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2**15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0,
                 decr_ratio=0.5):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None

    def get_loss_scaling(self):
        """The persistable loss-scale variable ([1] f32)."""
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        _mark_amp_ops(program, self._amp_lists)
        self._loss_scaling = _make_scalar(
            unique_name.generate('loss_scaling'), 'float32',
            self._init_loss_scaling)
        block = program.global_block()
        scaled_loss = block.create_var(
            name=unique_name.generate('scaled_loss'), shape=loss.shape,
            dtype=loss.dtype)
        block.append_op('elementwise_mul',
                        inputs={'X': loss, 'Y': self._loss_scaling},
                        outputs={'Out': scaled_loss}, attrs={'axis': -1})
        self._scaled_loss = block.vars[scaled_loss.name]
        return self._optimizer.backward(self._scaled_loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_gradients(self, params_grads):
        with default_main_program()._role_guard('optimize'):
            return self._apply_gradients_impl(params_grads)

    def _apply_gradients_impl(self, params_grads):
        block = default_main_program().global_block()
        grads = [g for _, g in params_grads if g is not None]
        unscaled = []
        for g in grads:
            u = block.create_var(
                name=unique_name.generate(g.name + '_unscaled'),
                shape=g.shape, dtype=g.dtype)
            u.stop_gradient = True
            unscaled.append(u)
        found_inf = block.create_var(
            name=unique_name.generate('found_inf'), shape=(), dtype='bool')
        found_inf.stop_gradient = True
        block.append_op('check_finite_and_unscale',
                        inputs={'X': grads, 'Scale': self._loss_scaling},
                        outputs={'Out': unscaled,
                                 'FoundInfinite': found_inf},
                        infer_shape=False)
        if self._use_dynamic:
            good = _make_scalar(unique_name.generate('good_steps'),
                                'int32', 0)
            bad = _make_scalar(unique_name.generate('bad_steps'),
                               'int32', 0)
            block.append_op(
                'update_loss_scaling',
                inputs={'FoundInfinite': found_inf,
                        'PrevLossScaling': self._loss_scaling,
                        'InGoodSteps': good, 'InBadSteps': bad},
                outputs={'LossScaling': self._loss_scaling,
                         'OutGoodSteps': good, 'OutBadSteps': bad},
                attrs={'incr_every_n_steps': self._incr_every_n_steps,
                       'decr_every_n_nan_or_inf':
                           self._decr_every_n_nan_or_inf,
                       'incr_ratio': self._incr_ratio,
                       'decr_ratio': self._decr_ratio},
                infer_shape=False)
        new_pg = []
        i = 0
        for p, g in params_grads:
            if g is None:
                new_pg.append((p, g))
            else:
                new_pg.append((p, unscaled[i]))
                i += 1
        return self._optimizer.apply_gradients(new_pg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program,
                                     parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2**15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=True):
    """Reference decorator.py decorate(): `optimizer` wrapped for bf16
    compute with loss scaling (dynamic unless asked otherwise)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio)

"""Optimizers: append update ops to the program.

Reference: python/paddle/fluid/optimizer.py — Optimizer.minimize(:690) =
append_backward + apply_gradients(:575); per-optimizer
_append_optimize_op (:293).  Each optimizer adds the same ops, vars and
startup ops as the JAX package's (fluid/optimizer.py), so the two
training programs serialize alike.  Ported: the Optimizer base with
gradient clipping and regularization, SGD, Momentum, LarsMomentum, Adam,
AdamW, Adamax, Adadelta, RMSProp, Ftrl, LAMB, Adagrad (with its sparse
embedding-row rewrite), DecayedAdagrad, Dpsgd, DGCMomentum, and the
wrappers Recompute, ModelAverage, ExponentialMovingAverage and
Lookahead.
"""

import contextlib

import torch

from . import core, unique_name
from .backward import append_backward
from .flags import get_flag
from .framework import (Variable, default_main_program,
                        default_startup_program)


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators = {}  # acc_name -> {param_name: var}
        self._learning_rate_map = {}
        self.type = getattr(self, 'type', 'optimizer')

    # -- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if self._learning_rate_map.get(program) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        name = unique_name.generate('learning_rate')
        lr_var = program.global_block().create_var(
            name=name, shape=(1,), dtype='float32', persistable=True)
        lr_var.stop_gradient = True
        sb = default_startup_program().global_block()
        sb.create_var(name=name, shape=(1,), dtype='float32',
                      persistable=True)
        sb.append_op('fill_constant', outputs={'Out': name},
                     attrs={'shape': [1], 'dtype': 'float32',
                            'value': float(self._learning_rate)})
        self._learning_rate_map[program] = lr_var

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base_lr = self._global_learning_rate()
        param_lr = getattr(param, 'optimize_attr',
                           {'learning_rate': 1.0}).get('learning_rate', 1.0)
        if param_lr == 1.0:
            return base_lr
        from .layers import ops as _ops
        return _ops.scale(base_lr, scale=float(param_lr))

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        var_name = unique_name.generate(param.name + '_' + name)
        block = default_main_program().global_block()
        var = block.create_var(name=var_name, shape=tuple(shape),
                               dtype=dtype, persistable=True)
        var.stop_gradient = True
        sb = default_startup_program().global_block()
        sb.create_var(name=var_name, shape=tuple(shape), dtype=dtype,
                      persistable=True)
        sb.append_op('fill_constant', outputs={'Out': var_name},
                     attrs={'shape': shape, 'dtype': dtype,
                            'value': float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- pipeline ----------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Reference: optimizer.py:575."""
        with default_main_program()._role_guard('optimize'):
            return self._apply_gradients_impl(params_grads)

    def _apply_gradients_impl(self, params_grads):
        from .clip import append_gradient_clip_ops
        from .regularizer import append_regularization_ops
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        else:
            params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        block = default_main_program().global_block()
        self._create_global_learning_rate()
        self._create_accumulators(block, [p for p, g in params_grads])
        optimize_ops = [self._append_optimize_op(block, pg)
                        for pg in params_grads if pg[1] is not None]
        self._finish_update(block, params_grads)
        return optimize_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """Reference: optimizer.py:690."""
        if grad_clip is not None:
            self._grad_clip = grad_clip
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            'sgd',
            inputs={'Param': p, 'Grad': g,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    """A velocity per parameter (op momentum, with or without
    Nesterov's correction)."""
    type = 'momentum'

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('velocity', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator('velocity', p)
        return block.append_op(
            'momentum',
            inputs={'Param': p, 'Grad': g, 'Velocity': velocity,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'VelocityOut': velocity},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    type = 'adam'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment1', p)
            self._add_accumulator('moment2', p)
        if parameters:
            # ONE beta-pow pair for the whole optimizer, as in the JAX
            # package: every dense parameter's powers follow the same
            # beta^t, read by every adam op and advanced once a step in
            # _finish_update
            self._shared_pow_param = parameters[0]
            self._add_accumulator('beta1_pow_acc', parameters[0],
                                  fill_value=1.0, shape=[1])
            self._add_accumulator('beta2_pow_acc', parameters[0],
                                  fill_value=1.0, shape=[1])

    def _get_accumulator(self, name, param):
        if name in ('beta1_pow_acc', 'beta2_pow_acc'):
            param = self._shared_pow_param
        return super(AdamOptimizer, self)._get_accumulator(name, param)

    def _adam_inputs(self, param_and_grad):
        p, g = param_and_grad
        return {'Param': p, 'Grad': g,
                'Moment1': self._get_accumulator('moment1', p),
                'Moment2': self._get_accumulator('moment2', p),
                'Beta1Pow': self._get_accumulator('beta1_pow_acc', p),
                'Beta2Pow': self._get_accumulator('beta2_pow_acc', p),
                'LearningRate': self._create_param_lr(param_and_grad)}

    def _adam_op(self, block, param_and_grad, attrs):
        ins = self._adam_inputs(param_and_grad)
        return block.append_op(
            self.type, inputs=ins,
            outputs={'ParamOut': ins['Param'], 'Moment1Out': ins['Moment1'],
                     'Moment2Out': ins['Moment2']},
            attrs=attrs, infer_shape=False)

    def _append_optimize_op(self, block, param_and_grad):
        return self._adam_op(block, param_and_grad,
                             {'beta1': self._beta1, 'beta2': self._beta2,
                              'epsilon': self._epsilon})

    def _finish_update(self, block, params_grads):
        if not params_grads:
            return
        p = params_grads[0][0]
        for acc, beta in ((self._get_accumulator('beta1_pow_acc', p),
                           self._beta1),
                          (self._get_accumulator('beta2_pow_acc', p),
                           self._beta2)):
            block.append_op('scale', inputs={'X': acc},
                            outputs={'Out': acc},
                            attrs={'scale': beta,
                                   '__optimizer_finish__': True},
                            infer_shape=False)


class AdamWOptimizer(AdamOptimizer):
    type = 'adamw'

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super(AdamWOptimizer, self).__init__(learning_rate, **kwargs)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        return self._adam_op(block, param_and_grad,
                             {'beta1': self._beta1, 'beta2': self._beta2,
                              'epsilon': self._epsilon,
                              'coeff': self._coeff})


class AdagradOptimizer(Optimizer):
    type = 'adagrad'

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator('moment', p)
        fused = self._try_fused_emb_update(block, p, g, moment,
                                           param_and_grad)
        if fused is not None:
            return fused
        return block.append_op(
            'adagrad',
            inputs={'Param': p, 'Grad': g, 'Moment': moment,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'MomentOut': moment},
            attrs={'epsilon': self._epsilon}, infer_shape=False)

    def _try_fused_emb_update(self, block, p, g, moment, param_and_grad):
        """The sparse embedding-table path (ops/kernels/embedding.py):
        when this parameter's gradient comes straight from a
        lookup_table(_v2)_grad op and no op reads it, that op (a
        scatter of the rows into a [V, D] gradient) and the adagrad
        over the whole table become one fused_emb_update over the
        looked-up rows, which reads the lookup's output gradient and
        ids.  Any other topology (clipping, regularization, a table
        read by several lookups, whose gradient is then a sum) keeps
        the dense pair.  FLAGS_torch_emb_update off keeps it too."""
        if not get_flag('FLAGS_torch_emb_update', True) or g is None:
            return None
        producer_idx = None
        for i, op in enumerate(block.ops):
            if g.name in op.output_arg_names:
                producer_idx = i
        if producer_idx is None:
            return None
        prod = block.ops[producer_idx]
        if prod.type not in ('lookup_table_grad', 'lookup_table_v2_grad'):
            return None
        if any(g.name in op.input_arg_names for op in block.ops):
            return None
        if prod.inputs['W'][0] != p.name:
            return None
        op = block.append_op(
            'fused_emb_update',
            inputs={'Param': p, 'Grad': prod.inputs['GRAD::Out'][0],
                    'Ids': prod.inputs['Ids'][0], 'Moment': moment,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'MomentOut': moment},
            attrs={'epsilon': self._epsilon,
                   'padding_idx': prod.attrs.get('padding_idx', -1)},
            infer_shape=False)
        # the scatter is dead now (its W@GRAD has no reader): the
        # executor never runs it
        block._remove_op(producer_idx)
        return op


class LambOptimizer(AdamOptimizer):
    type = 'lamb'

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super(LambOptimizer, self).__init__(learning_rate, beta1=beta1,
                                            beta2=beta2, epsilon=epsilon,
                                            **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    # per-parameter beta powers, each advanced by its own lamb op
    # (Beta1PowOut / Beta2PowOut), so no finishing ops
    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment1', p)
            self._add_accumulator('moment2', p)
            self._add_accumulator('beta1_pow_acc', p, fill_value=1.0,
                                  shape=[1])
            self._add_accumulator('beta2_pow_acc', p, fill_value=1.0,
                                  shape=[1])

    def _get_accumulator(self, name, param):
        return Optimizer._get_accumulator(self, name, param)

    def _finish_update(self, block, params_grads):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        ins = self._adam_inputs(param_and_grad)
        return block.append_op(
            'lamb', inputs=ins,
            outputs={'ParamOut': ins['Param'], 'Moment1Out': ins['Moment1'],
                     'Moment2Out': ins['Moment2'],
                     'Beta1PowOut': ins['Beta1Pow'],
                     'Beta2PowOut': ins['Beta2Pow']},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon, 'weight_decay': wd},
            infer_shape=False)


class RecomputeOptimizer(Optimizer):
    """Activation checkpointing around another optimizer (reference
    optimizer.py:3611; the JAX package's fluid/optimizer.py:624):
    ``_set_checkpoints`` names the variables kept from the forward, and
    the backward (fluid/backward.py ``_RecomputePlan``) recomputes each
    span between them."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               callbacks, checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class LarsMomentumOptimizer(Optimizer):
    """Momentum with the layer-wise LARS rate (op lars_momentum)."""
    type = 'lars_momentum'

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super(LarsMomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('velocity', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        velocity = self._get_accumulator('velocity', p)
        return block.append_op(
            'lars_momentum',
            inputs={'Param': p, 'Grad': g, 'Velocity': velocity,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'VelocityOut': velocity},
            attrs={'mu': self._momentum, 'lars_coeff': self._lars_coeff,
                   'lars_weight_decay': self._lars_weight_decay},
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    """A moment, an infinity norm and a beta1 power (filled beta1) per
    parameter; each power is scaled by beta1 after the updates."""
    type = 'adamax'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p)
            self._add_accumulator('inf_norm', p)
            self._add_accumulator('beta1_pow_acc', p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator('moment', p)
        inf_norm = self._get_accumulator('inf_norm', p)
        return block.append_op(
            'adamax',
            inputs={'Param': p, 'Grad': g, 'Moment': moment,
                    'InfNorm': inf_norm,
                    'Beta1Pow': self._get_accumulator('beta1_pow_acc', p),
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'MomentOut': moment,
                     'InfNormOut': inf_norm},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon}, infer_shape=False)

    def _finish_update(self, block, params_grads):
        for p, g in params_grads:
            b1p = self._get_accumulator('beta1_pow_acc', p)
            block.append_op('scale', inputs={'X': b1p},
                            outputs={'Out': b1p},
                            attrs={'scale': self._beta1},
                            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    """Two running averages per parameter (of the squared gradient and
    of the squared update); no learning-rate input."""
    type = 'adadelta'

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('avg_squared_grad', p)
            self._add_accumulator('avg_squared_update', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator('avg_squared_grad', p)
        asu = self._get_accumulator('avg_squared_update', p)
        return block.append_op(
            'adadelta',
            inputs={'Param': p, 'Grad': g, 'AvgSquaredGrad': asg,
                    'AvgSquaredUpdate': asu},
            outputs={'ParamOut': p, 'AvgSquaredGradOut': asg,
                     'AvgSquaredUpdateOut': asu},
            attrs={'epsilon': self._epsilon, 'rho': self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    """A momentum, a mean square and a mean gradient per parameter (the
    mean gradient read and written only when centered)."""
    type = 'rmsprop'

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('momentum', p)
            self._add_accumulator('mean_square', p)
            self._add_accumulator('mean_grad', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator('momentum', p)
        ms = self._get_accumulator('mean_square', p)
        mg = self._get_accumulator('mean_grad', p)
        return block.append_op(
            'rmsprop',
            inputs={'Param': p, 'Grad': g, 'Moment': mom,
                    'MeanSquare': ms, 'MeanGrad': mg,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'MomentOut': mom, 'MeanSquareOut': ms,
                     'MeanGradOut': mg},
            attrs={'decay': self._rho, 'epsilon': self._epsilon,
                   'momentum': self._momentum, 'centered': self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    type = 'ftrl'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('squared', p)
            self._add_accumulator('linear', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator('squared', p)
        lin = self._get_accumulator('linear', p)
        return block.append_op(
            'ftrl',
            inputs={'Param': p, 'Grad': g, 'SquaredAccumulator': sq,
                    'LinearAccumulator': lin,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'SquaredAccumOut': sq,
                     'LinearAccumOut': lin},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power}, infer_shape=False)


class DpsgdOptimizer(Optimizer):
    """SGD on the clipped gradient plus Gaussian noise (op dpsgd);
    batch_size is accepted and not read, as in the JAX package."""
    type = 'dpsgd'

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kwargs):
        super(DpsgdOptimizer, self).__init__(learning_rate, **kwargs)
        self._clip, self._sigma = clip, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            'dpsgd',
            inputs={'Param': p, 'Grad': g,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p},
            attrs={'clip': self._clip, 'sigma': self._sigma},
            infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad whose squared-gradient sum decays (op decayed_adagrad)."""
    type = 'decayed_adagrad'

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('moment', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        moment = self._get_accumulator('moment', p)
        return block.append_op(
            'decayed_adagrad',
            inputs={'Param': p, 'Grad': g, 'Moment': moment,
                    'LearningRate': self._create_param_lr(param_and_grad)},
            outputs={'ParamOut': p, 'MomentOut': moment},
            attrs={'decay': self._decay, 'epsilon': self._epsilon},
            infer_shape=False)


class DGCMomentumOptimizer(MomentumOptimizer):
    """Momentum through Deep Gradient Compression (reference
    optimizer.py:952, operators/dgc_op.h): each gradient goes through
    the dgc op (momentum folded into its u accumulator, the top of |v|
    sent, the rest kept) and the parameter takes an sgd step on what is
    sent.  rampup_begin_step is kept and not read, as in the JAX
    package."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 **kwargs):
        super(DGCMomentumOptimizer, self).__init__(
            learning_rate, momentum, use_nesterov, **kwargs)
        self._rampup_begin_step = rampup_begin_step
        self._sparsity = sparsity[-1] if isinstance(
            sparsity, (list, tuple)) else sparsity

    def _create_accumulators(self, block, parameters):
        super(DGCMomentumOptimizer, self)._create_accumulators(
            block, parameters)
        for p in parameters:
            self._add_accumulator('dgc_u', p)
            self._add_accumulator('dgc_v', p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator('dgc_u', p)
        v = self._get_accumulator('dgc_v', p)
        encoded = block.create_var(
            name=unique_name.generate(g.name + '_dgc'),
            shape=tuple(p.shape), dtype=p.dtype)
        encoded.stop_gradient = True
        block.append_op('dgc', inputs={'Grad': g, 'U': u, 'V': v},
                        outputs={'EncodeGrad': encoded, 'UOut': u,
                                 'VOut': v, 'GradOut': encoded},
                        attrs={'m': self._momentum,
                               'sparsity_ratio': self._sparsity},
                        infer_shape=False)
        return block.append_op(
            'sgd',
            inputs={'Param': p, 'Grad': encoded,
                    'LearningRate': self._create_param_lr((p, encoded))},
            outputs={'ParamOut': p}, infer_shape=False)


class ModelAverage(object):
    """A running sum of each trainable parameter and a step count, kept
    in the program (reference optimizer.py:2759): construction appends
    the count's increment and one add a parameter (optimize role) and
    their startup fills.  ``apply()`` is a context manager that puts
    sum / max(count, 1) into each parameter for evaluation and, with
    need_restore, puts the parameters back on exit (``restore``).  Both
    write into the scope's existing tensors (copy_), so CUDA graphs
    that hold the parameters' storage stay valid."""

    def __init__(self, average_window_rate=0.15,
                 min_average_window=10000, max_average_window=10000,
                 **kwargs):
        self._avg = {}
        block = default_main_program().global_block()
        sb = default_startup_program().global_block()
        self._params = [p for p in block.all_parameters()
                        if getattr(p, 'trainable', True)]
        self._count_name = unique_name.generate('ma_count')
        block.create_var(name=self._count_name, shape=(1,),
                         dtype='float32', persistable=True)
        sb.create_var(name=self._count_name, shape=(1,), dtype='float32',
                      persistable=True)
        sb.append_op('fill_constant', outputs={'Out': self._count_name},
                     attrs={'shape': [1], 'dtype': 'float32',
                            'value': 0.0})
        with default_main_program()._role_guard('optimize'):
            block.append_op('increment', inputs={'X': self._count_name},
                            outputs={'Out': self._count_name},
                            attrs={'step': 1.0}, infer_shape=False)
            for p in self._params:
                name = unique_name.generate(p.name + '_ma_sum')
                block.create_var(name=name, shape=p.shape, dtype=p.dtype,
                                 persistable=True)
                sb.create_var(name=name, shape=p.shape, dtype=p.dtype,
                              persistable=True)
                sb.append_op('fill_constant', outputs={'Out': name},
                             attrs={'shape': list(p.shape),
                                    'dtype': p.dtype, 'value': 0.0})
                block.append_op('elementwise_add',
                                inputs={'X': name, 'Y': p},
                                outputs={'Out': name}, attrs={'axis': -1},
                                infer_shape=False)
                self._avg[p.name] = name
        self._backup = {}

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def guard():
            scope = core.global_scope()
            count = core.as_array(scope.find_var(self._count_name))
            count = torch.clamp(count.reshape(()).float(), min=1.0)
            self._backup = {}
            with torch.no_grad():
                for p in self._params:
                    t = core.as_array(scope.find_var(p.name))
                    self._backup[p.name] = t.clone()
                    avg = core.as_array(scope.find_var(self._avg[p.name]))
                    t.copy_(avg / count.to(avg.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore()
        return guard()

    def restore(self, executor=None):
        scope = core.global_scope()
        with torch.no_grad():
            for name, val in self._backup.items():
                core.as_array(scope.find_var(name)).copy_(val)
        self._backup = {}


class ExponentialMovingAverage(object):
    """The parameters' moving averages (reference optimizer.py:3063, the
    JAX package's form): ``update()`` adds, for each trainable
    parameter, a persistable `<param>.<name>` filled with 0 by the
    startup program and the ops ema = decay * ema + (1 - decay) * param
    after everything appended so far (so after ``minimize``, the
    updated parameters).  Like the JAX package's, it has no apply /
    restore and no thres_steps."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or 'ema'
        self._ema_vars = {}

    def update(self):
        block = default_main_program().global_block()
        sb = default_startup_program().global_block()
        for p in block.all_parameters():
            if not p.trainable:
                continue
            name = p.name + '.' + self._name
            ema = block.create_var(name=name, shape=p.shape, dtype=p.dtype,
                                   persistable=True)
            ema.stop_gradient = True
            sb.create_var(name=name, shape=p.shape, dtype=p.dtype,
                          persistable=True)
            sb.append_op('fill_constant', outputs={'Out': name},
                         attrs={'shape': list(p.shape), 'dtype': p.dtype,
                                'value': 0.0})
            self._ema_vars[p.name] = ema
            tmp = block.create_var(
                name=unique_name.generate(name + '_tmp'),
                shape=p.shape, dtype=p.dtype)
            block.append_op('scale', inputs={'X': ema},
                            outputs={'Out': tmp},
                            attrs={'scale': self._decay})
            block.append_op('scale', inputs={'X': p},
                            outputs={'Out': name},
                            attrs={'scale': 1 - self._decay},
                            infer_shape=False)
            block.append_op('elementwise_add',
                            inputs={'X': tmp, 'Y': name},
                            outputs={'Out': name}, infer_shape=False)


class LookaheadOptimizer(object):
    """Lookahead (reference optimizer.py LookaheadOptimizer): the inner
    optimizer steps the fast weights every step; every k-th step the
    slow weights move alpha of the way to the fast ones and the fast
    weights take them.  In the program, as in the JAX package: a step
    counter, a 0/1 gate from step mod k, and each new value a gated
    sum, so the step has no branch on the host."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert isinstance(k, int) and k > 0
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from . import layers
        mini_out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        block = main.global_block()
        params = [p.name for p in block.all_parameters()]

        with main._role_guard('optimize'):
            k = layers.fill_constant([1], 'int32', self.k)
            layers.fill_constant([1], 'int32', 1)
            zero = layers.fill_constant([1], 'int32', 0)
            step = layers.autoincreased_step_counter(begin=1)
            step_i = layers.cast(step, 'int32')
            mod = layers.elementwise_mod(step_i, k)
            gate = layers.cast(layers.equal(mod, zero), 'float32')
            for name in params:
                fast = block.var(name)
                axis = 0 if len(fast.shape) == 1 else -1
                slow_name = name + '@SLOW'
                slow = block.create_var(name=slow_name, shape=fast.shape,
                                        dtype=fast.dtype, persistable=True)
                sb = startup.global_block()
                sb.create_var(name=slow_name, shape=fast.shape,
                              dtype=fast.dtype, persistable=True)
                sb.append_op('assign', inputs={'X': name},
                             outputs={'Out': slow_name}, infer_shape=False)
                diff = layers.elementwise_sub(fast, slow)
                cand = layers.elementwise_add(
                    slow, layers.scale(diff, scale=self.alpha))
                inv = layers.elementwise_sub(
                    layers.fill_constant([1], 'float32', 1.0), gate)
                new_slow = layers.elementwise_add(
                    layers.elementwise_mul(cand, gate, axis=axis),
                    layers.elementwise_mul(slow, inv, axis=axis))
                block.append_op('assign', inputs={'X': new_slow},
                                outputs={'Out': slow_name},
                                infer_shape=False)
                new_fast = layers.elementwise_add(
                    layers.elementwise_mul(new_slow, gate, axis=axis),
                    layers.elementwise_mul(fast, inv, axis=axis))
                block.append_op('assign', inputs={'X': new_fast},
                                outputs={'Out': name}, infer_shape=False)
        return mini_out


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Dpsgd = DpsgdOptimizer
Lamb = LambOptimizer

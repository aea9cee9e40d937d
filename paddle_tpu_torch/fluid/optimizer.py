"""Optimizers: append update ops to the program.

Reference: python/paddle/fluid/optimizer.py — Optimizer.minimize(:690) =
append_backward + apply_gradients(:575); per-optimizer
_append_optimize_op (:293).  Each optimizer adds the same ops, vars and
startup ops as the JAX package's (fluid/optimizer.py), so the two
training programs serialize alike.  Ported: the Optimizer base with
gradient clipping and regularization, Adam, AdamW, LAMB and Adagrad
(with its sparse embedding-row rewrite).
"""

from . import unique_name
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


Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adagrad = AdagradOptimizer
Lamb = LambOptimizer

"""Weight-decay regularizers appended as ops on gradients.

Reference: python/paddle/fluid/regularizer.py (append_regularization_ops).
The ops are the JAX package's (fluid/regularizer.py): the decay term
scaled from the parameter and added to its gradient.
"""

from . import unique_name


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=unique_name.generate(param.name + '_l2decay'),
            shape=param.shape, dtype=param.dtype)
        block.append_op('scale', inputs={'X': param},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff})
        out = block.create_var(
            name=unique_name.generate(grad.name + '_reg'),
            shape=param.shape, dtype=param.dtype)
        block.append_op('elementwise_add',
                        inputs={'X': grad, 'Y': decay},
                        outputs={'Out': out})
        return out


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate(param.name + '_sign'),
            shape=param.shape, dtype=param.dtype)
        block.append_op('sign', inputs={'X': param}, outputs={'Out': sign})
        decay = block.create_var(
            name=unique_name.generate(param.name + '_l1decay'),
            shape=param.shape, dtype=param.dtype)
        block.append_op('scale', inputs={'X': sign},
                        outputs={'Out': decay},
                        attrs={'scale': self._coeff})
        out = block.create_var(
            name=unique_name.generate(grad.name + '_reg'),
            shape=param.shape, dtype=param.dtype)
        block.append_op('elementwise_add',
                        inputs={'X': grad, 'Y': decay},
                        outputs={'Out': out})
        return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    res = []
    for param, grad in params_grads:
        if grad is None:
            res.append((param, grad))
            continue
        reg = getattr(param, 'regularizer', None) or regularization
        if reg is None:
            res.append((param, grad))
            continue
        block = param.block.program.global_block()
        res.append((param, reg(param, grad, block)))
    return res

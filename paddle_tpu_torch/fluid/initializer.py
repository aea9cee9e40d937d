"""Initializers appending init ops to the startup program.

Reference: python/paddle/fluid/initializer.py — each initializer appends a
fill_constant / gaussian_random / uniform_random op on the parameter var
to the startup program.  The executor runs those ops like any other;
the random ones draw from a ``torch.Generator`` seeded from the
program's random_seed and the op's seed (ops/tensor_ops.py).
"""

import contextlib

import numpy as np


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            'fill_constant', outputs={'Out': var.name},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            'uniform_random', outputs={'Out': var.name},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self.low, 'max': self.high})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            'gaussian_random', outputs={'Out': var.name},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self.loc, 'std': self.scale})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot. Reference initializer.py XavierInitializer."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std)(var, block)


# Aliases matching fluid's public names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


def force_init_on_cpu():
    return False


@contextlib.contextmanager
def init_on_cpu():
    """Reference initializer.py init_on_cpu: the initializer ops of its
    body on the CPU.  The port's startup programs run where their
    executor's place says, so the guard changes nothing, as in the JAX
    package."""
    yield

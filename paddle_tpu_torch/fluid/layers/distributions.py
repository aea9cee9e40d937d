"""Distribution classes (reference
python/paddle/fluid/layers/distributions.py: Uniform, Normal,
Categorical, MultivariateNormalDiag): sample, entropy, log_prob and
kl_divergence as the layers the JAX package's
fluid/layers/distributions.py appends.  A sample in a main program is
drawn on the device from the counter hash (uniform_random,
gaussian_random), not by jax threefry."""

import math

import numpy as np

from ..layer_helper import LayerHelper
from ..framework import Variable
from . import tensor as _t
from . import nn as _nn
from . import ops as _ops

__all__ = ['Distribution', 'Uniform', 'Normal', 'Categorical',
           'MultivariateNormalDiag']


def _to_var(v, like=None):
    if isinstance(v, Variable):
        return v
    arr = np.asarray(v, 'float32')
    return _t.assign(arr)


class Distribution(object):
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U[low, high) (reference distributions.py Uniform)."""

    def __init__(self, low, high):
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        from . import more_layers as _m
        u = _m.uniform_random(shape, min=0.0, max=1.0, seed=seed)
        span = _nn.elementwise_sub(self.high, self.low)
        return _nn.elementwise_add(
            self.low, _nn.elementwise_mul(u, span))

    def entropy(self):
        return _ops.log(_nn.elementwise_sub(self.high, self.low))

    def log_prob(self, value):
        span = _nn.elementwise_sub(self.high, self.low)
        lb = _t.cast(_ops.less_than(self.low, value), 'float32')
        ub = _t.cast(_ops.less_than(value, self.high), 'float32')
        inside = _nn.elementwise_mul(lb, ub)
        return _nn.elementwise_sub(
            _ops.log(inside), _ops.log(span))


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        from . import more_layers as _m
        z = _m.gaussian_random(shape, mean=0.0, std=1.0, seed=seed)
        return _nn.elementwise_add(
            self.loc, _nn.elementwise_mul(z, self.scale))

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2 * math.pi)
        return _nn.elementwise_add(
            _t.fill_constant([1], 'float32', c),
            _ops.log(self.scale))

    def log_prob(self, value):
        var = _nn.elementwise_mul(self.scale, self.scale)
        d = _nn.elementwise_sub(value, self.loc)
        quad = _nn.elementwise_div(_nn.elementwise_mul(d, d),
                                   _ops.scale(var, scale=2.0))
        log_z = _nn.elementwise_add(
            _ops.log(self.scale),
            _t.fill_constant([1], 'float32',
                             0.5 * math.log(2 * math.pi)))
        return _ops.scale(_nn.elementwise_add(quad, log_z), scale=-1.0)

    def kl_divergence(self, other):
        var_a = _nn.elementwise_mul(self.scale, self.scale)
        var_b = _nn.elementwise_mul(other.scale, other.scale)
        d = _nn.elementwise_sub(self.loc, other.loc)
        t1 = _nn.elementwise_div(
            _nn.elementwise_add(var_a, _nn.elementwise_mul(d, d)),
            _ops.scale(var_b, scale=2.0))
        t2 = _nn.elementwise_sub(_ops.log(other.scale),
                                 _ops.log(self.scale))
        half = _t.fill_constant([1], 'float32', 0.5)
        return _nn.elementwise_sub(
            _nn.elementwise_add(t1, t2), half)


class Categorical(Distribution):
    def __init__(self, logits):
        self.logits = logits

    def entropy(self):
        p = _nn.softmax(self.logits)
        logp = _nn.elementwise_sub(
            self.logits,
            _ops.log(_nn.reduce_sum(_ops.exp(self.logits), dim=[-1],
                                    keep_dim=True)))
        return _ops.scale(
            _nn.reduce_sum(_nn.elementwise_mul(p, logp), dim=[-1]),
            scale=-1.0)

    def kl_divergence(self, other):
        p = _nn.softmax(self.logits)
        logp = _nn.elementwise_sub(
            self.logits,
            _ops.log(_nn.reduce_sum(_ops.exp(self.logits), dim=[-1],
                                    keep_dim=True)))
        logq = _nn.elementwise_sub(
            other.logits,
            _ops.log(_nn.reduce_sum(_ops.exp(other.logits), dim=[-1],
                                    keep_dim=True)))
        return _nn.reduce_sum(
            _nn.elementwise_mul(p, _nn.elementwise_sub(logp, logq)),
            dim=[-1])


class MultivariateNormalDiag(Distribution):
    def __init__(self, loc, scale):
        """scale: diagonal covariance matrix (reference passes a [D, D]
        diag matrix)."""
        self.loc = loc
        self.scale = scale

    def _diag(self):
        d = self.scale.shape[-1]
        return _nn.reduce_sum(
            _nn.elementwise_mul(
                self.scale,
                _t.assign(np.eye(d, dtype='float32'))), dim=[-1])

    def entropy(self):
        d = self.scale.shape[-1]
        c = 0.5 * d * (1.0 + math.log(2 * math.pi))
        logdet = _nn.reduce_sum(_ops.log(self._diag()))
        return _nn.elementwise_add(
            _t.fill_constant([1], 'float32', c),
            _ops.scale(logdet, scale=0.5))

    def kl_divergence(self, other):
        da = self._diag()
        db = other._diag()
        d = _nn.elementwise_sub(self.loc, other.loc)
        tr = _nn.reduce_sum(_nn.elementwise_div(da, db))
        quad = _nn.reduce_sum(_nn.elementwise_div(
            _nn.elementwise_mul(d, d), db))
        k = _t.fill_constant([1], 'float32',
                             float(self.scale.shape[-1]))
        logdet = _nn.elementwise_sub(
            _nn.reduce_sum(_ops.log(db)),
            _nn.reduce_sum(_ops.log(da)))
        s = _nn.elementwise_add(tr, quad)
        s = _nn.elementwise_sub(s, k)
        s = _nn.elementwise_add(s, logdet)
        return _ops.scale(s, scale=0.5)

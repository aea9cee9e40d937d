"""The update op types of the core slice (lars_momentum, adamax,
adadelta, rmsprop with and without centering, ftrl at lr_power -0.5 and
another, dpsgd, proximal_gd with and without l1, dgc, decayed_adagrad)
on the CPU against the JAX package, from the same numpy inputs.

Tolerance: every output within rtol TOL = 1e-5 plus 1e-5 of its largest
magnitude (the JAX expression in its order, f32 on both sides); dgc's
bitwise where its inputs are exact (the threshold is the k-th largest
|v| whichever sort finds it).  dpsgd's noise comes from the port's
counter hash, not jax threefry: the gradient part is held at sigma 0,
the noise by its moments.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import close
from torch_image_cases import run_jax, run_torch

TOL = 1e-5


def _t(shape=(5, 7), seed=0, scale=1.0, pos=False):
    v = np.random.RandomState(seed).randn(*shape).astype('float32') * scale
    return np.abs(v) + 0.05 if pos else v


def _lr(v=0.01):
    return np.array([v], 'float32')


def _same(op, ins, attrs, tol=TOL):
    want, got = run_jax(op, ins, attrs), run_torch(op, ins, attrs)
    assert sorted(got) == sorted(want), op
    for s in want:
        for g, w in zip(got[s], want[s]):
            close(g, w, tol, '%s %s' % (op, s))


def test_lars_momentum_matches_jax():
    ins = {'Param': [_t()], 'Grad': [_t(seed=1)], 'Velocity': [_t(seed=2)],
           'LearningRate': [_lr()]}
    _same('lars_momentum', ins, {'mu': 0.9, 'lars_coeff': 0.001,
                                 'lars_weight_decay': 0.0005})
    ins['Param'] = [np.zeros((5, 7), 'float32')]  # ||p|| = 0: plain lr
    _same('lars_momentum', ins, {'mu': 0.8})


def test_adamax_matches_jax():
    _same('adamax', {'Param': [_t()], 'Grad': [_t(seed=1)],
                     'Moment': [_t(seed=2)], 'InfNorm': [_t(seed=3, pos=True)],
                     'Beta1Pow': [np.array([0.9 ** 3], 'float32')],
                     'LearningRate': [_lr()]},
          {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8})


def test_adadelta_matches_jax():
    _same('adadelta', {'Param': [_t()], 'Grad': [_t(seed=1)],
                       'AvgSquaredGrad': [_t(seed=2, pos=True)],
                       'AvgSquaredUpdate': [_t(seed=3, pos=True)]},
          {'rho': 0.95, 'epsilon': 1e-6})


@pytest.mark.parametrize('centered', [False, True])
def test_rmsprop_matches_jax(centered):
    """Centered: MeanGradOut written; not centered: only the three."""
    ins = {'Param': [_t()], 'Grad': [_t(seed=1)], 'Moment': [_t(seed=2)],
           'MeanSquare': [_t(seed=3, pos=True) + 1.0],
           'MeanGrad': [_t(seed=4, scale=0.1)], 'LearningRate': [_lr()]}
    _same('rmsprop', ins, {'decay': 0.9, 'epsilon': 1e-3, 'momentum': 0.9,
                           'centered': centered})


@pytest.mark.parametrize('lr_power', [-0.5, -0.3])
def test_ftrl_matches_jax(lr_power):
    _same('ftrl', {'Param': [_t()], 'Grad': [_t(seed=1)],
                   'SquaredAccumulator': [_t(seed=2, pos=True)],
                   'LinearAccumulator': [_t(seed=3)],
                   'LearningRate': [_lr(0.1)]},
          {'l1': 0.3, 'l2': 0.2, 'lr_power': lr_power})


@pytest.mark.parametrize('l1', [0.0, 0.05])
def test_proximal_gd_matches_jax(l1):
    _same('proximal_gd', {'Param': [_t()], 'Grad': [_t(seed=1)],
                          'LearningRate': [_lr(0.5)]}, {'l1': l1, 'l2': 0.1})


def test_decayed_adagrad_matches_jax():
    _same('decayed_adagrad', {'Param': [_t()], 'Grad': [_t(seed=1)],
                              'Moment': [_t(seed=2, pos=True)],
                              'LearningRate': [_lr()]},
          {'decay': 0.9, 'epsilon': 1e-6})


@pytest.mark.parametrize('ratio', [0.999, 0.8])
def test_dgc_bitwise(ratio):
    """u, v and the sent gradient exactly, with inputs exact in f32
    (multiples of 1/8), so both sides round alike."""
    r = np.random.RandomState(5)
    ins = {'Grad': [(r.randint(-40, 40, (6, 9)) / 8).astype('float32')],
           'U': [(r.randint(-40, 40, (6, 9)) / 8).astype('float32')],
           'V': [(r.randint(-40, 40, (6, 9)) / 8).astype('float32')]}
    _same('dgc', ins, {'m': 0.5, 'sparsity_ratio': ratio}, tol=0)
    sent = run_torch('dgc', ins, {'m': 0.5, 'sparsity_ratio': ratio})
    k = max(1, int(54 * (1 - ratio)))
    assert np.count_nonzero(sent['EncodeGrad'][0]) >= k


def test_dpsgd_clip_exact_and_noise_by_statistics():
    """sigma 0: the clipped step against the JAX package's; sigma 2,
    clip 0.5 over 200k elements of zero gradient: the noise
    (p - p_out) / lr has mean 0 and std sigma * clip within 5 sigma of
    the sampling error, and a replay of the step draws it again."""
    g = _t(scale=3.0)
    for clip in (0.5, 100.0):
        _same('dpsgd', {'Param': [_t()], 'Grad': [g],
                        'LearningRate': [_lr()]},
              {'clip': clip, 'sigma': 0.0})
    n = 200000
    p = np.zeros((n,), 'float32')
    ins = {'Param': [torch.as_tensor(p)], 'Grad': [torch.zeros(n)],
           'LearningRate': [torch.as_tensor(_lr(1.0))]}
    attrs = {'clip': 0.5, 'sigma': 2.0}

    def step(k):
        ctx = treg.LowerCtx(step=k, op_seed=3, device='cpu')
        return treg.get('dpsgd').run(ctx, ins, attrs)['ParamOut'][0].numpy()

    noise = -step(1).astype(np.float64)
    assert abs(noise.mean()) < 5 * 1.0 / np.sqrt(n)
    assert abs(noise.std() - 1.0) < 5 * 1.0 / np.sqrt(2 * n)
    np.testing.assert_array_equal(step(1), -noise.astype(np.float32))
    assert not np.array_equal(step(2), step(1))

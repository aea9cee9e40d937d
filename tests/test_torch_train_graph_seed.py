"""What a replayed training step draws, computed on the device: the
attention-dropout seed and the dropout op's mask (ops/registry.py and
ops/kernels/dropout.py), on the CPU.

- ``LowerCtx.dropout_seed`` is a 0-d int64 tensor computed from the
  device step, bitwise the JAX package's uint32 ``dropout_seed`` over a
  grid of op seeds (their products with 2654435761 wrapping mod 2**32)
  and steps past 2**31; past 2**32, where the JAX context cannot take
  the step, bitwise the same formula in numpy uint32 arithmetic;
- the plain K1 and K2 (flash_attention_plain, flash_attention_bwd_plain,
  f32 and bf16) with that seed as a tensor are bitwise the same with
  the seed as an int;
- the dropout op's counter hash (``hash_keep``) is bitwise a numpy
  uint32 reference, keeps 1 - p of 200,000 elements within 0.004 (the
  keep rate's standard deviation is 6.7e-4 there), repeats for the same
  (op, step), differs across steps and ranks, and its grad op replays
  the same mask.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

from paddle_tpu.ops import registry as jregistry

import torch

from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import dropout as tdropout
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

OP_SEEDS = (0, 1, 5, 1000003, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
            3 * 2 ** 32 + 17)
STEPS = (0, 1, 2, 1000, 2 ** 20 + 7, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 9,
         2 ** 32 - 1)
RATE = 0.1


def _numpy_seed(op_seed, step):
    with np.errstate(over='ignore'):
        return int(np.uint32(op_seed * 2654435761 % (1 << 32)) ^
                   (np.uint32(step % (1 << 32)) * np.uint32(0x9E3779B9)))


@pytest.mark.parametrize('op_seed', OP_SEEDS)
def test_device_seed_is_the_jax_dropout_seed(op_seed):
    for step in STEPS:
        want = int(jregistry.LowerCtx(step, op_seed).dropout_seed({}))
        got = tregistry.LowerCtx(step, op_seed).dropout_seed({})
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want == _numpy_seed(op_seed, step), (op_seed,
                                                                step)


def test_device_seed_past_two_to_the_32():
    for op_seed in OP_SEEDS:
        for step in (2 ** 32, 2 ** 32 + 5, 2 ** 40 + 11, 2 ** 62 + 3):
            got = tregistry.LowerCtx(step, op_seed).dropout_seed({})
            assert int(got) == _numpy_seed(op_seed, step), (op_seed, step)


def test_device_seed_reads_the_step_tensor():
    """The executor's device step (a graph's static input while one is
    captured) is what the seed is computed from, not the context's host
    int; the ops of a run share the step's mix."""
    from paddle_tpu_torch import fluid as tfluid
    exe = tfluid.Executor(tfluid.CPUPlace())
    for step in (2 ** 31 + 9, 3):
        exe._step_t = torch.tensor(step, dtype=torch.int64)
        exe._step_mixes = None
        ctx = tregistry.LowerCtx(1, 5, step_mix=exe._step_mix)
        assert int(ctx.dropout_seed({})) == _numpy_seed(5, step)
        other = tregistry.LowerCtx(1, 6, step_mix=exe._step_mix)
        assert int(other.dropout_seed({})) == _numpy_seed(6, step)
        assert list(exe._step_mixes) == [0x9E3779B9]
        assert exe._step_mix(0x9E3779B9) is exe._step_mixes[0x9E3779B9]
    assert tregistry.LowerCtx(1, 5).dropout_seed({'is_test': True}) is None


def _qkv(dtype, b=2, t=24, h=2, d=32, seed=0):
    rng = np.random.RandomState(seed)
    xs = [torch.from_numpy(rng.randn(b, t, h, d).astype('float32')).to(
        dtype) for _ in range(4)]
    bias = torch.from_numpy(np.where(rng.rand(b, t) < 0.2, -10000.0,
                                     0.0).astype('float32'))
    return xs, bias


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_plain_kernels_take_the_seed_as_a_tensor(dtype):
    (q, k, v, do), bias = _qkv(dtype)
    seed_int = _numpy_seed(7, 2 ** 31 + 9)
    seed_t = tregistry.LowerCtx(2 ** 31 + 9, 7).dropout_seed({})
    outs = [tfa.flash_attention_plain(q, k, v, False, bias, RATE, s)
            for s in (seed_int, seed_t)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    grads = [tfa.flash_attention_bwd_plain(q, k, v, bias, do, None, False,
                                           RATE, s, True)
             for s in (seed_int, seed_t)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    other = tfa.flash_attention_plain(q, k, v, False, bias, RATE,
                                      seed_int ^ 1)[0]
    assert not torch.equal(outs[0][0], other)


def test_keep_mask_with_a_seed_tensor_is_the_int_seeds():
    for seed in (0, 1, 2 ** 31, 2 ** 32 - 1):
        a = tfa.dropout_keep_plain(seed, 2, 3, 16, 16, RATE)
        b = tfa.dropout_keep_plain(torch.tensor(seed), 2, 3, 16, 16, RATE)
        assert torch.equal(a, b), seed


def _hash_reference(seed, n, rate):
    i = np.arange(n, dtype=np.uint32)
    with np.errstate(over='ignore'):
        h = (i * np.uint32(0x9E3779B1)) ^ np.uint32(seed)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x7FEB352D)
        h ^= h >> np.uint32(15)
        h *= np.uint32(0x846CA68B)
        h ^= h >> np.uint32(16)
    return (h >> np.uint32(8)) < int(round((1.0 - rate) * (1 << 24)))


@pytest.mark.parametrize('seed', [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_hash_keep_is_the_uint32_reference(seed):
    got = tdropout.hash_keep(torch.tensor(seed), (37, 41), 0.25, 'cpu')
    assert got.shape == (37, 41) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy().ravel(),
                                  _hash_reference(seed, 37 * 41, 0.25))


def _dropout(ctx, x, p=RATE):
    attrs = {'dropout_prob': p, 'dropout_implementation': 'upscale_in_train'}
    return tregistry.get('dropout').run(ctx, {'X': [x]}, attrs)


def test_dropout_keep_rate_and_keying():
    x = torch.ones(400, 500)
    mask = _dropout(tregistry.LowerCtx(3, 5, random_seed=2), x)['Mask'][0]
    assert abs(mask.mean().item() - (1 - RATE)) < 0.004
    again = _dropout(tregistry.LowerCtx(3, 5, random_seed=2), x)['Mask'][0]
    assert torch.equal(mask, again)
    for ctx in (tregistry.LowerCtx(4, 5, random_seed=2),
                tregistry.LowerCtx(3, 6, random_seed=2),
                tregistry.LowerCtx(3, 5, random_seed=3),
                tregistry.LowerCtx(3, 5, random_seed=2,
                                   replica=tregistry.Replica(None, 1, 2))):
        assert not torch.equal(mask, _dropout(ctx, x)['Mask'][0])
    # the step is read from the device step
    t = torch.tensor(3)
    dev = _dropout(tregistry.LowerCtx(
        99, 5, random_seed=2, step_mix=lambda c: tfa.mul32(t, c)),
        x)['Mask'][0]
    assert torch.equal(mask, dev)


def test_dropout_grad_replays_the_mask():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(64, 96).astype('float32'))
    g = torch.from_numpy(rng.randn(64, 96).astype('float32'))
    ctx = tregistry.LowerCtx(7, 11, random_seed=4)
    out = _dropout(ctx, x)
    attrs = {'dropout_prob': RATE,
             'dropout_implementation': 'upscale_in_train'}
    dx = tregistry.get('dropout_grad').run(
        ctx, {'X': [x], 'GRAD::Out': [g]}, attrs)['GRAD::X'][0]
    keep = out['Mask'][0] > 0
    assert torch.equal(dx, torch.where(keep, g / (1 - RATE),
                                       torch.zeros_like(g)))
    assert torch.equal(out['Out'][0], torch.where(keep, x / (1 - RATE),
                                                  torch.zeros_like(x)))

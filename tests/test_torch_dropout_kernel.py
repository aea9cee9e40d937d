"""The dropout op's kernel module (ops/kernels/dropout.py) on the CPU:
its registration and launch counter, its CPU path (the plain version,
since the tensors lie on the CPU) forward and backward, and the op's
formula against the JAX package's.

- forward: Out and Mask bitwise the op's formula as the port computed
  it before the kernel (``torch.where(keep, x / max(1 - p, 1e-8), 0)``
  with a Python divisor, an IEEE division on the CPU, and ``x * mask``)
  over ``hash_keep``'s mask, f32 and bf16, both implementations,
  p in {0, 0.1, 1}, NaN and infinite inputs among the values (compared
  as bits);
- backward: the autograd Function's gradient bitwise autograd's through
  that formula;
- the formula against the JAX package's dropout op: given the JAX op's
  own Mask (it draws jax.random.bernoulli, so the masks differ), the
  port's Out is the JAX Out in f32: equal values for
  downgrade_in_infer (XLA's product with a 0 keeps no sign), within one
  ulp (rtol 2.4e-7) for upscale_in_train, which XLA computes as a
  product with the reciprocal of 1 - p;
- the op in a Program run by the executor on the CPU: Out, Mask and the
  whole-program gradient bitwise the plain version.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import dropout as dk

SHAPE = (5, 7, 33)  # 1155 elements: no multiple of a 16-byte vector


def _bits(t):
    """Integer view of a float tensor, so NaNs compare by their bits."""
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _x(dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*SHAPE).astype(np.float32))
    flat = x.view(-1)
    flat[:6] = torch.tensor([float('nan'), -float('nan'), float('inf'),
                             -float('inf'), -0.0, 0.0])
    return x.to(dtype)


def _seed(v=0x9E3779B1 ^ 12345):
    return torch.tensor(v, dtype=torch.int64)


def _old_formula(x, keep, p, upscale):
    """The dropout op's lowering before the kernel."""
    mask = keep.to(x.dtype)
    if upscale:
        out = torch.where(keep, x / max(1.0 - p, 1e-8), torch.zeros_like(x))
    else:
        out = x * mask
    return out, mask


def test_registration_and_launch_counter():
    info = common.KERNELS['dropout']
    assert info['source'] == 'dropout_mask.cu'
    assert info['op_types'] == ('dropout',)
    assert info['replaces'].startswith('none')
    assert 'hash_keep' in info['plain']
    assert dk.keep_threshold(0.1) == 15099494
    assert dk.keep_threshold(0) == 1 << 24 and dk.keep_threshold(1) == 0
    before = common.launches('dropout')
    x = _x(torch.float32)
    dk.dropout(x, _seed(), 0.1, True)  # the CPU path launches nothing
    assert common.launches('dropout') == before
    common.check_launch('dropout', None, 0)
    assert common.launches('dropout') == before + 1
    common.KERNELS['dropout']['launches'] = before


@pytest.mark.parametrize('p', [0.0, 0.1, 1.0])
@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_forward_is_the_plain_formula_bitwise(dtype, upscale, p):
    x = _x(dtype)
    out, mask = dk.dropout(x, _seed(), p, upscale)
    keep = dk.hash_keep(_seed(), SHAPE, p, 'cpu')
    want_out, want_mask = _old_formula(x, keep, p, upscale)
    assert out.dtype == mask.dtype == dtype
    assert torch.equal(_bits(out), _bits(want_out))
    assert torch.equal(_bits(mask), _bits(want_mask))
    kept = int(keep.sum())
    if p == 0.0:
        assert kept == keep.numel()
    elif p == 1.0:
        assert kept == 0
    if upscale:  # a dropped NaN gives 0
        assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))
    elif not bool(keep.view(-1)[0]):  # NaN * 0 stays NaN
        assert torch.isnan(out.view(-1)[0])


@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backward_is_autograds_bitwise(dtype, upscale):
    x = torch.from_numpy(np.random.RandomState(1).randn(*SHAPE).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(np.random.RandomState(2).randn(*SHAPE).astype(
        np.float32)).to(dtype)
    g.view(-1)[:3] = torch.tensor([float('nan'), float('inf'), -1e30])
    xa = x.clone().requires_grad_()
    out, mask = dk.dropout(xa, _seed(), 0.1, upscale)
    assert not mask.requires_grad
    got, = torch.autograd.grad(out, xa, g)
    xb = x.clone().requires_grad_()
    keep = dk.hash_keep(_seed(), SHAPE, 0.1, 'cpu')
    want_out, _ = dk.apply_keep(xb, keep, 0.1, upscale)
    want, = torch.autograd.grad(want_out, xb, g)
    assert torch.equal(_bits(got), _bits(want))
    # and the formula the backward states
    if upscale:
        s = max(1.0 - 0.1, 1e-8)
        manual = torch.where(keep, (g.float() / s).to(dtype),
                             torch.zeros_like(g))
    else:
        manual = g * keep.to(dtype)
    assert torch.equal(_bits(got), _bits(manual))


def _jax_dropout(x, p, impl):
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 3
    with jfluid.program_guard(main, startup):
        xv = jfluid.layers.data('x', shape=list(SHAPE[1:]), dtype='float32')
        out = jfluid.layers.dropout(xv, p, dropout_implementation=impl)
    op = [o for o in main.global_block().ops if o.type == 'dropout'][0]
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        return exe.run(main, feed={'x': x},
                       fetch_list=[out, op.output('Mask')[0]])


@pytest.mark.parametrize('impl', ['upscale_in_train', 'downgrade_in_infer'])
def test_formula_matches_jax_given_its_mask(impl):
    x = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    jout, jmask = (np.asarray(a) for a in _jax_dropout(x, 0.1, impl))
    keep = torch.from_numpy(jmask != 0)
    assert 0.8 < float(keep.float().mean()) < 0.97
    out, mask = dk.apply_keep(torch.from_numpy(x), keep, 0.1,
                              impl == 'upscale_in_train')
    if impl == 'upscale_in_train':
        # XLA multiplies by the reciprocal of 0.9 (one rounding more than
        # the port's IEEE division): within one ulp
        np.testing.assert_allclose(out.numpy(), jout, rtol=2.4e-7, atol=0)
    else:
        # equal values; XLA gives +0 where x * 0 is -0 for a negative x
        assert np.array_equal(out.numpy(), jout)
    assert np.array_equal(mask.numpy(), jmask)


def test_op_in_a_program_is_the_plain_version():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 7
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        xv = tfluid.layers.data('x', shape=[8], dtype='float32')
        h = tfluid.layers.fc(xv, size=8)
        d = tfluid.layers.dropout(
            h, 0.25, dropout_implementation='upscale_in_train')
        loss = tfluid.layers.mean(d)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    op = [o for o in main.global_block().ops if o.type == 'dropout'][0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    w_grad = main._grad_name_map['fc_0.w_0']
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w = scope.find_var('fc_0.w_0').clone()
        plan = exe._get_plan(main, {'x': x}, [loss.name, w_grad])
        assert plan.kind == 'wpg'
        hv, dv, mv, gw = exe.run(
            main, feed={'x': x},
            fetch_list=[h, d, op.output('Mask')[0], w_grad],
            return_numpy=False)
    seed = tregistry.LowerCtx(exe._step, op.attrs["__op_seed__"],
                              random_seed=7).dropout_op_seed()
    want, want_mask = dk.dropout_plain(hv, seed, 0.25, True)
    assert torch.equal(dv, want) and torch.equal(mv, want_mask)
    # d(mean(dropout(x W + b)))/dW through the saved mask
    gd = dk.dropout_grad(torch.full_like(hv, 1.0 / hv.numel()), want_mask,
                         0.25, True)
    assert torch.allclose(gw, torch.from_numpy(x).t() @ gd, atol=1e-7)
    assert not torch.equal(w, scope.find_var('fc_0.w_0'))


def test_non_contiguous_input_and_the_int32_guard():
    x = _x(torch.float32)
    view = x.transpose(0, 2)
    out, mask = dk.dropout(view, _seed(), 0.1, True)
    want, want_mask = dk.dropout_plain(view.contiguous(), _seed(), 0.1, True)
    assert torch.equal(_bits(out), _bits(want))
    assert torch.equal(mask, want_mask)
    with pytest.raises(ValueError, match='int32'):
        dk.hash_keep(_seed(), (1 << 16, 1 << 15), 0.1, 'meta')

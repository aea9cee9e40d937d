"""The dropout op's gradient from the saved seed and its Mask written only
where it is read (ops/kernels/dropout.py, ops/nn_ops.py, the executor's
run plans), on the CPU.

- ``dropout_grad_plain`` (the gradient kernel's plain version: the keep
  bits computed again from the seed) is bitwise ``dropout_grad`` from the
  saved Mask, f32 and bf16, both implementations, p in {0, 0.1, 1}, with
  NaN, +-inf and -0 among the gradients (compared as bits);
- the autograd Function's backward (which keeps the seed, not Mask) is
  bitwise autograd through the plain formula, with and without Mask;
- the formula against the JAX package's dropout gradient: given the
  JAX op's own Mask (it draws jax.random.bernoulli, so the masks
  differ), the port's dX is the JAX dX (equal values for
  downgrade_in_infer, within one ulp for upscale_in_train, which XLA
  computes with the reciprocal of 1 - p);
- the run plans: under the whole-program grad and on the per-op grad
  path every dropout's Mask is unread and its lowering returns none,
  a fetched Mask is read and written, and the grad op's replay of the
  forward leaves Mask out;
- seeded BERT-tiny and Transformer-tiny programs give the same loss,
  gradients and updated parameters bit for bit with a Mask fetched,
  with none fetched, and on the per-op grad path (an intermediate's
  gradient fetched).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)
import jax.numpy as jnp

from paddle_tpu.ops import registry as jregistry

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import dropout as dk

SHAPE = (5, 7, 33)  # 1155 elements: no multiple of a 16-byte vector
RATE = 0.1


def _bits(t):
    """Integer view of a float tensor, so NaNs compare by their bits."""
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _g(dtype, seed=2):
    g = torch.from_numpy(np.random.RandomState(seed).randn(*SHAPE).astype(
        np.float32))
    g.view(-1)[:6] = torch.tensor([float('nan'), -float('nan'), float('inf'),
                                   -float('inf'), -0.0, 0.0])
    return g.to(dtype)


def _seed(v=0x9E3779B1 ^ 2024):
    return torch.tensor(v, dtype=torch.int64)


def test_registration_and_launch_counter():
    info = common.KERNELS['dropout_grad']
    assert info['source'] == common.KERNELS['dropout']['source'] == \
        'dropout_mask.cu'
    assert info['op_types'] == ('dropout',)
    assert info['replaces'].startswith('none')
    assert 'dropout_grad_plain' in info['plain']
    before = common.launches('dropout_grad')
    x = _g(torch.float32).requires_grad_()
    out, mask = dk.dropout(x, _seed(), RATE, True, False)
    assert mask is None
    torch.autograd.grad(out, x, _g(torch.float32, 3))
    assert common.launches('dropout_grad') == before  # the CPU path


@pytest.mark.parametrize('p', [0.0, 0.1, 1.0])
@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_grad_from_the_seed_is_the_grad_from_the_mask(dtype, upscale, p):
    g = _g(dtype)
    mask = dk.hash_keep(_seed(), SHAPE, p, 'cpu').to(dtype)
    got = dk.dropout_grad_plain(g, _seed(), p, upscale)
    want = dk.dropout_grad(g, mask, p, upscale)
    assert got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    # what the gradient kernel states: keep ? g / s : 0, or g * m
    keep = mask != 0
    if upscale:
        assert torch.equal(_bits(got[~keep]),
                           _bits(torch.zeros_like(got[~keep])))
    elif not bool(keep.view(-1)[0]):
        assert torch.isnan(got.view(-1)[0])  # NaN * 0 stays NaN
    if p == 0.0:
        assert bool(keep.all())


@pytest.mark.parametrize('upscale', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backward_is_autograd_through_the_formula(dtype, upscale):
    x = torch.from_numpy(np.random.RandomState(1).randn(*SHAPE).astype(
        np.float32)).to(dtype)
    g = _g(dtype)
    keep = dk.hash_keep(_seed(), SHAPE, RATE, 'cpu')
    xb = x.clone().requires_grad_()
    want, = torch.autograd.grad(dk.apply_keep(xb, keep, RATE, upscale)[0],
                                xb, g)
    for write_mask in (True, False):
        xa = x.clone().requires_grad_()
        out, mask = dk.dropout(xa, _seed(), RATE, upscale, write_mask)
        assert (mask is not None) == write_mask
        got, = torch.autograd.grad(out, xa, g)
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize('impl', ['upscale_in_train', 'downgrade_in_infer'])
def test_grad_formula_matches_jax_given_its_mask(impl):
    rng = np.random.RandomState(4)
    x = rng.randn(*SHAPE).astype(np.float32)
    g = rng.randn(*SHAPE).astype(np.float32)
    attrs = {'dropout_prob': RATE, 'dropout_implementation': impl}
    ctx = jregistry.LowerCtx(step=1, op_seed=3, prefer_test=False)
    jmask = np.array(jregistry.get('dropout').run(
        ctx, {'X': [jnp.asarray(x)]}, attrs)['Mask'][0])
    jdx = np.asarray(jregistry.get('dropout_grad').run(
        ctx, {'X': [jnp.asarray(x)], 'GRAD::Out': [jnp.asarray(g)]},
        attrs)['GRAD::X'][0])
    assert 0.8 < float((jmask != 0).mean()) < 0.97
    dx = dk.dropout_grad(torch.from_numpy(g), torch.from_numpy(jmask), RATE,
                         impl == 'upscale_in_train').numpy()
    if impl == 'upscale_in_train':
        np.testing.assert_allclose(dx, jdx, rtol=2.4e-7, atol=0)
    else:
        assert np.array_equal(dx, jdx)


def test_lowering_leaves_out_an_unread_mask():
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 9).astype(
        np.float32))
    attrs = {'dropout_prob': RATE,
             'dropout_implementation': 'upscale_in_train'}
    op = tregistry.get('dropout')
    full = op.run(tregistry.LowerCtx(3, 7, random_seed=2), {'X': [x]}, attrs)
    ctx = tregistry.LowerCtx(3, 7, random_seed=2, unread=('Mask',))
    assert ctx.writes('Out') and not ctx.writes('Mask')
    part = op.run(ctx, {'X': [x]}, attrs)
    assert sorted(part) == ['Out'] and sorted(full) == ['Mask', 'Out']
    assert torch.equal(part['Out'][0], full['Out'][0])
    test = op.run(ctx, {'X': [x]}, dict(attrs, is_test=True))
    assert sorted(test) == ['Out']
    # the grad op's replay of the forward leaves Mask out: the context it
    # hands the forward
    seen = []
    real = op.fn
    try:
        op.fn = lambda c, ins, a: seen.append(c.unread) or real(c, ins, a)
        dx = tregistry.grad_op_def(op).run(
            tregistry.LowerCtx(3, 7, random_seed=2),
            {'X': [x], 'GRAD::Out': [torch.ones_like(x)]}, attrs)
    finally:
        op.fn = real
    assert seen == [frozenset({'Mask'})]
    assert torch.equal(dx['GRAD::X'][0], torch.where(
        full['Mask'][0] != 0, torch.ones_like(x) / (1 - RATE),
        torch.zeros_like(x)))


def _bert():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, _, loss = tbert.build_pretrain(tbert.TINY, seq_len=16)
        tfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    feed = tbert.synthetic_batch(tbert.TINY, 2, 16, np.random.RandomState(0))
    return main, startup, loss, feed


def _transformer():
    cfg = ttr.TransformerConfig(src_vocab=500, tgt_vocab=500, d_model=64,
                                heads=4, ffn=128, enc_layers=2, dec_layers=2,
                                dropout=0.1, max_len=64)
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, _, loss = ttr.build(cfg, src_len=12, tgt_len=12)
        tfluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    feed = ttr.synthetic_batch(cfg, 3, 12, 12, np.random.RandomState(1))
    return main, startup, loss, feed


def _dropouts(main):
    return [op for op in main.global_block().ops if op.type == 'dropout']


def _plan_ops(plan):
    if plan.kind == 'wpg':
        return list(plan.pre)
    return [st for step in plan.steps for st in step.members]


def test_plans_mark_mask_unread_unless_fetched():
    main, startup, loss, feed = _bert()
    drops = _dropouts(main)
    mask0 = drops[0].output('Mask')[0]
    via_grad = main._grad_name_map[drops[0].output('Out')[0]]
    exe = tfluid.Executor(tfluid.CPUPlace())
    cases = (([loss.name], 'wpg', ()), ([loss.name, mask0], 'wpg', (0,)),
             ([loss.name, via_grad], 'per_op', ()))
    for fetch, kind, fetched in cases:
        plan = exe._get_plan(main, feed, fetch)
        assert plan.kind == kind
        steps = [st for st in _plan_ops(plan) if st.op.type == 'dropout']
        assert [st.op for st in steps] == drops
        for i, st in enumerate(steps):
            assert ('Mask' in st.unread) == (i not in fetched), (fetch, i)
            assert 'Out' not in st.unread
        if kind == 'per_op':
            grads = [st for st in _plan_ops(plan)
                     if st.op.type == 'dropout_grad']
            assert len(grads) == len(drops)


@pytest.mark.parametrize('build', [_bert, _transformer],
                         ids=['bert_tiny', 'transformer_tiny'])
def test_steps_are_bitwise_with_and_without_mask_and_per_op(build):
    main, startup, loss, feed = build()
    drops = _dropouts(main)
    assert drops
    params = sorted(p.name for p in main.all_parameters())
    grads = [main._grad_name_map[p] for p in params]
    extra = {'mask not fetched': [],
             'mask fetched': [drops[-1].output('Mask')[0]],
             'per-op grad path': [
                 main._grad_name_map[drops[0].output('Out')[0]]]}
    runs = {}
    for case, more in extra.items():
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe.run(startup)
            fetch = [loss.name] + grads + more
            kind = exe._get_plan(main, feed, fetch).kind
            assert kind == ('per_op' if case == 'per-op grad path'
                            else 'wpg')
            outs = [exe.run(main, feed=feed, fetch_list=fetch,
                            return_numpy=False)[:1 + len(grads)]
                    for _ in range(2)]
            state = [scope.find_var(p).clone() for p in params]
            if case == 'mask fetched':
                mask = exe.run(main, feed=feed, fetch_list=fetch,
                               return_numpy=False)[-1]
                seed = tregistry.LowerCtx(
                    exe._step, drops[-1].attrs['__op_seed__'],
                    random_seed=main.random_seed).dropout_op_seed()
                assert torch.equal(mask, dk.hash_keep(
                    seed, mask.shape, drops[-1].attrs['dropout_prob'],
                    'cpu').float())
        runs[case] = (outs, state)
    ref_outs, ref_state = runs['mask not fetched']
    for case, (outs, state) in runs.items():
        for a_step, b_step in zip(ref_outs, outs):
            for a, b in zip(a_step, b_step):
                assert torch.equal(_bits(a), _bits(b)), case
        for a, b in zip(ref_state, state):
            assert torch.equal(_bits(a), _bits(b)), case

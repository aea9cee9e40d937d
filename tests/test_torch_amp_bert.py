"""Mixed precision on BERT's flash path against the JAX package, on the
CPU: the plain bf16 versions of K1 and K2 against the Pallas kernels
run in interpret mode at bf16, and a small BERT (2 layers, hidden 64, 4
heads, seq 64, flash_min_len 0 so attention is the fused op, hidden
dropout 0, attention dropout 0.1) trained under
decorate(Adam(1e-3, epsilon 1e-6)) with dynamic loss scaling.

The port runs its own startup program (step 1, as the JAX executor
counts it), then takes the JAX package's startup values, so both draw
the same attention-dropout masks.  The master parameters stay f32; the
activations run in bf16.

Tolerances, and why:
- the kernels: O, dQ, dK, dV within one bf16 rounding (rtol and atol of
  max|JAX| 2^-8): both take bf16 products with f32 accumulation and
  round P and dS to bf16 at the same points, in other summation orders;
  lse and the bias cotangent (f32) within rtol 1e-5 and 1e-5 of their
  largest;
- the losses of 3 steps, each package from its own state, within rel
  1e-2: every product, bias add, residual and normalization output is
  rounded to bf16 on both sides, XLA in its order and with its own
  elementwise roundings;
- the loss scale and the good and bad counters exact at every step;
- an overflowing step from the same state: the verdict exact, the scale
  halved, the counters exact, Adam's moments exact (beta times the old,
  as zero gradients give), the beta powers exact and the parameters
  within rtol 1e-5 plus 1e-6 of their largest (Adam moves them by
  lr_t * m / (sqrt(v) + epsilon), lr_t from the beta powers, in another
  order of operations: a bias that is its first step differs by 2e-6
  of itself).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as jfa

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

SEQ = 64
STEPS = 3
ULP = 2.0 ** -8
SCALE_STATE = ('loss_scaling_0', 'good_steps_0', 'bad_steps_0')


# ------------------------------------------------------------- kernels
def _kernel_inputs(seed, bias_kind):
    rng = np.random.RandomState(seed)
    b, t, h, d = 2, 128, 2, 16
    q, k, v, do = [rng.randn(b, t, h, d).astype('float32') for _ in range(4)]
    glse = rng.randn(b, h, t).astype('float32')
    bias = None
    if bias_kind is not None:
        bias = np.where(rng.rand(b, t) < 0.3, -10000.0,
                        rng.randn(b, t)).astype('float32')
        if bias_kind == 'row_masked':
            bias[1] = -np.inf
    return q, k, v, do, glse, bias


def _bf16_close(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=ULP,
                               atol=ULP * float(np.abs(want).max()),
                               err_msg=what)


def _f32_close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize('causal,rate,bias_kind', [
    (False, 0.1, 'padding'), (True, 0.0, None), (False, 0.1, 'row_masked')])
def test_plain_bf16_kernels_match_pallas_at_bf16(causal, rate, bias_kind):
    """O, lse and the gradients of q, k, v and the bias, the forward's
    and the backward's plain bf16 versions against the Pallas kernels'
    bf16 forms (the fused one-pass backward), with an lse cotangent."""
    q, k, v, do, glse, bias = _kernel_inputs(3, bias_kind)
    seed = 77 if rate else None
    prim = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    if bias is not None:
        prim.append(jnp.asarray(bias))

    def f(q, k, v, *b):
        return jfa.flash_attention_with_lse(
            q, k, v, causal=causal, key_bias=b[0] if b else None,
            dropout_rate=rate,
            dropout_seed=jnp.uint32(seed) if rate else None)

    (jo, jlse), vjp = jax.vjp(f, *prim)
    want = vjp((jnp.asarray(do, jnp.bfloat16), jnp.asarray(glse)))
    tq, tk, tv = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    tb = None if bias is None else torch.from_numpy(bias)
    before = common.launches('flash_attention')
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal, tb, rate, seed)
    got = tfa.flash_attention_bwd_plain(
        tq, tk, tv, tb, torch.from_numpy(do).to(torch.bfloat16),
        torch.from_numpy(glse), causal, rate, seed, bias_grad=tb is not None)
    assert common.launches('flash_attention') == before  # CPU: plain
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _bf16_close(o, jo, 'O')
    _f32_close(lse, jlse, 'lse')
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert g.dtype == torch.bfloat16
        _bf16_close(g, w, name)
    if bias is not None:
        _f32_close(got[3], want[3], 'dbias')


def test_autograd_of_the_flash_function_takes_the_bf16_backward():
    """flash_attention on bf16 CPU tensors: autograd runs the plain bf16
    backward (P and dS rounded), not autograd of the forward."""
    q, k, v, do, _, bias = _kernel_inputs(4, 'padding')
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
              for x in (q, k, v)]
    tb = torch.from_numpy(bias)
    o = tfa.flash_attention(*leaves, key_bias=tb, dropout_rate=0.1,
                            dropout_seed=5)
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    got = torch.autograd.grad(o, leaves, tdo)
    want = tfa.flash_attention_bwd_plain(*[x.detach() for x in leaves], tb,
                                         tdo, None, False, 0.1, 5)
    for g, w in zip(got, want[:3]):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


# ---------------------------------------------------------------- BERT
def _cfg(bert_mod):
    cfg = bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                              heads=4, intermediate=128, max_pos=64,
                              dropout=0.0, attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _build(fluid, bert_mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = bert_mod.build_pretrain(_cfg(bert_mod), seq_len=SEQ)
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6),
            use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    return main, startup, loss


def _overflowing(state, decoder):
    """`state` with the loss scale at 2^127 and one bad step behind it,
    and the MLM decoder weight times 64: the gradients behind the
    decoder grow past 2, so the scaled ones overflow f32 (and bf16) in
    either package, while the forward stays finite; the scale halves."""
    out = dict(state)
    out['loss_scaling_0'] = np.array([2.0 ** 127], 'float32')
    out['bad_steps_0'] = np.array([1], 'int32')
    out[decoder] = state[decoder] * np.float32(64.0)
    return out


@pytest.fixture(scope='module')
def runs():
    batch = tbert.synthetic_batch(_cfg(tbert), 4, SEQ,
                                  np.random.RandomState(0))
    jmain, jstartup, jloss = _build(jfluid, jbert)
    tmain, tstartup, tloss = _build(tfluid, tbert)
    names = weights.startup_names(tstartup)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state0 = weights.numpy_state(jscope, names)
        jlosses, jscales = [], []
        for _ in range(STEPS):
            jlosses.append(float(jexe.run(jmain, feed=batch,
                                          fetch_list=[jloss])[0]))
            jscales.append(weights.numpy_state(jscope, SCALE_STATE))
        decoder = [p.name for p in jmain.all_parameters()
                   if tuple(p.shape) == (64, 1000)][0]
        before = _overflowing(weights.numpy_state(jscope, names), decoder)
        for n in SCALE_STATE + (decoder,):
            jscope.set_var(n, jnp.asarray(before[n]))
        jfound = jexe.run(jmain, feed=batch, fetch_list=['found_inf_0'])[0]
        jafter = weights.numpy_state(jscope, names)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe.run(tstartup)
        weights.load_numpy_params(tscope, state0, tfluid.CPUPlace(),
                                  tstartup)
        tlosses, tscales, dtypes = [], [], {}
        for i in range(STEPS):
            out = texe.run(tmain, feed=batch, return_numpy=False,
                           fetch_list=[tloss, 'fc_0.tmp_1',
                                       tmain._grad_name_map['fc_0.w_0']])
            tlosses.append(float(out[0]))
            tscales.append(weights.numpy_state(tscope, SCALE_STATE))
            dtypes = {'loss': out[0].dtype, 'activation': out[1].dtype,
                      'grad': out[2].dtype}
        weights.load_numpy_params(tscope, before, tfluid.CPUPlace(),
                                  tstartup)
        tfound = texe.run(tmain, feed=batch, fetch_list=['found_inf_0'])[0]
        tafter = weights.numpy_state(tscope, names)
        tparams = {p.name: tscope.find_var(p.name).dtype
                   for p in tmain.all_parameters()}
    return dict(jlosses=jlosses, tlosses=tlosses, jscales=jscales,
                tscales=tscales, jfound=jfound, tfound=tfound, before=before,
                jafter=jafter, tafter=tafter, dtypes=dtypes, tparams=tparams,
                steps=(jexe._step, texe._step))


def test_losses_of_three_steps_match_jax(runs):
    assert runs['steps'][0] == runs['steps'][1]
    assert all(np.isfinite(runs['tlosses']))
    np.testing.assert_allclose(runs['tlosses'], runs['jlosses'], rtol=1e-2)


def test_loss_scaling_state_is_exact_every_step(runs):
    for j, t in zip(runs['jscales'], runs['tscales']):
        for n in SCALE_STATE:
            assert t[n].dtype == j[n].dtype
            np.testing.assert_array_equal(t[n], j[n], n)
    assert runs['tscales'][-1]['good_steps_0'].tolist() == [STEPS]


def test_activations_bf16_masters_and_grads_f32(runs):
    assert runs['dtypes'] == {'loss': torch.float32,
                              'activation': torch.bfloat16,
                              'grad': torch.float32}
    assert set(runs['tparams'].values()) == {torch.float32}


def test_adam_overflow_step_matches_jax(runs):
    """The verdict is true; the scale halves and the bad counter
    restarts; Adam's moments decay, its beta powers advance and its
    parameters move, as the JAX package's do."""
    assert bool(runs['tfound']) and bool(runs['jfound'])
    t, j, b = runs['tafter'], runs['jafter'], runs['before']
    assert t['loss_scaling_0'].tolist() == [2.0 ** 126]
    for n in SCALE_STATE:
        np.testing.assert_array_equal(t[n], j[n], n)
    moved = 0
    for n in t:
        if n in SCALE_STATE:
            continue
        if '_moment' in n or '_pow_acc_' in n or n == 'learning_rate_0':
            np.testing.assert_array_equal(t[n], j[n], n)
            if '_moment1_' in n:
                np.testing.assert_array_equal(t[n], np.float32(0.9) * b[n])
        else:
            np.testing.assert_allclose(
                t[n], j[n], rtol=1e-5,
                atol=1e-6 * float(np.abs(j[n]).max()), err_msg=n)
            moved += not np.array_equal(t[n], b[n])
    assert moved > 0

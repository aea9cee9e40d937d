"""The port's training slice against the JAX package, on the CPU: a
small BERT (2 layers, hidden 64, 4 heads, vocab 1000, seq 64,
flash_min_len 0 so attention is the fused op, hidden dropout 0 and
attention dropout 0.1) with Adam (lr 1e-3, BERT's epsilon 1e-6) takes 3
steps in both packages on the same feeds.  The port runs its own
startup program (step 1, as in the JAX executor), then takes the JAX
package's startup values through weights.load_numpy_params, so both
start every step from the same state with the same step number, hence
the same attention-dropout masks (the counter hash keyed on op seed and
step, bit-identical in both packages).  Hidden dropout is off: it draws
from jax threefry, which torch cannot reproduce (its statistics are
tested in tests/test_torch_train_ops.py).

Tolerances, and why: both sides compute in f32, in different summation
orders (XLA's fused loops against PyTorch's kernels), through 2 layers
forward and backward.  The per-step loss agrees to rtol 1e-5; the
step-1 gradients to atol 1e-5 of values up to ~1; the first moments
(0.1 * gradient sums) to atol 1e-6; the second moments to atol 1e-8
(their values are squares of 1e-3-scale gradients); the parameters,
which 3 Adam steps move by at most 3e-3, to atol 1e-5.  Epsilon 1e-6
keeps Adam from amplifying rounding noise where a gradient is
mathematically zero (the key projection's bias: softmax is
shift-invariant along each row), which at epsilon 1e-8 grows into
steps of up to lr * |g| / (|g| + epsilon) that differ between the
packages.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import registry as tregistry
from paddle_tpu_torch.ops.kernels import common

SEQ = 64
STEPS = 3
PROBE = ('embedding_0.w_0', 'fc_0.w_0', 'fc_0.w_1', 'layer_norm_0.w_0',
         'fc_8.w_0', 'fc_9.w_1')


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
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    return main, startup, loss


def _batch():
    return tbert.synthetic_batch(_cfg(tbert), 4, SEQ,
                                 np.random.RandomState(0))


def _train_port(state, batch, fetch_grad_of=()):
    """(losses, step-1 probe grads, final state, executor) of the port
    from `state`; the gradients of the variables `fetch_grad_of` are
    fetched beside the loss at every step."""
    main, startup, loss = _build(tfluid, tbert)
    grads = [main._grad_name_map[p] for p in PROBE]
    extra = [main._grad_name_map[n] for n in fetch_grad_of]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        weights.load_numpy_params(scope, state, tfluid.CPUPlace(), startup)
        out = [exe.run(main, feed=batch,
                       fetch_list=[loss] + extra + (grads if i == 0 else []))
               for i in range(STEPS)]
        final = {n: scope.find_var(n).clone() for n in state}
    return ([float(o[0]) for o in out], out[0][1 + len(extra):], final,
            exe)


@pytest.fixture(scope='module')
def runs():
    batch = _batch()
    jmain, jstartup, jloss = _build(jfluid, jbert)
    grads = [jmain._grad_name_map[p] for p in PROBE]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    tstartup = _build(tfluid, tbert)[1]
    names = weights.startup_names(tstartup)
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        state = {n: np.asarray(jscope.find_var(n)) for n in names}
        jout = [jexe.run(jmain, feed=batch,
                         fetch_list=[jloss] + (grads if i == 0 else []))
                for i in range(STEPS)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    before = {k: common.launches(k) for k in common.KERNELS}
    tlosses, tgrads, tfinal, texe = _train_port(state, batch)
    return dict(state=state, batch=batch, jexe=jexe, texe=texe,
                jlosses=[float(o[0]) for o in jout], tlosses=tlosses,
                jgrads=[np.asarray(g) for g in jout[0][1:]], tgrads=tgrads,
                jfinal=jfinal, tfinal=tfinal,
                launched={k: common.launches(k) - before[k]
                          for k in common.KERNELS})


def test_losses_match_every_step(runs):
    np.testing.assert_allclose(runs['tlosses'], runs['jlosses'], rtol=1e-5)
    assert all(np.isfinite(runs['tlosses']))


def test_step_counters_line_up(runs):
    """Startup is step 1 in both executors, the train steps 2..4: the
    attention-dropout seeds of every step are the JAX package's."""
    assert runs['jexe']._step == runs['texe']._step == 1 + STEPS


def test_step1_gradients_match(runs):
    for name, g, w in zip(PROBE, runs['tgrads'], runs['jgrads']):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def test_parameters_match_after_three_steps(runs):
    params = [n for n in runs['state'] if '_moment' not in n and
              '_pow_acc_' not in n and n != 'learning_rate_0']
    assert len(params) == 33  # 3 tables, 2 x 12 per layer, LN, 2 heads
    for n in params:
        np.testing.assert_allclose(runs['tfinal'][n].numpy(),
                                   runs['jfinal'][n], atol=1e-5, rtol=0,
                                   err_msg=n)
        assert not np.array_equal(runs['tfinal'][n].numpy(),
                                  runs['state'][n]), n


def test_moments_match_after_three_steps(runs):
    for n in runs['state']:
        if '_moment1_' in n or '_moment2_' in n:
            atol = 1e-6 if '_moment1_' in n else 1e-8
            np.testing.assert_allclose(runs['tfinal'][n].numpy(),
                                       runs['jfinal'][n], atol=atol,
                                       rtol=1e-5, err_msg=n)


def test_lr_and_beta_powers_match(runs):
    for n in ('learning_rate_0',) + tuple(
            n for n in runs['state'] if '_pow_acc_' in n):
        np.testing.assert_allclose(runs['tfinal'][n].numpy(),
                                   runs['jfinal'][n], rtol=1e-7, err_msg=n)
    b1 = [n for n in runs['state'] if 'beta1_pow' in n][0]
    np.testing.assert_allclose(runs['tfinal'][b1].numpy(), [0.9 ** STEPS],
                               rtol=1e-6)


def test_cpu_run_takes_the_plain_versions(runs):
    assert runs['launched'] == {k: 0 for k in common.KERNELS}


def test_whole_program_grad_equals_grad_ops_bitwise(runs):
    """The default backward (one autograd pass over the forward region)
    against running every synthesized grad op, each replaying its
    forward op: the same state after 3 steps, bit for bit.  Fetching
    the gradient of an intermediate (the embedding layer norm's output)
    is what sends a step down the per-op path: one autograd pass to the
    parameters does not yield it."""
    main, _, loss = _build(tfluid, tbert)
    ops = [op for op in main.global_block().ops
           if op.type not in tregistry.HOST_OPS]
    inter = main._grad_name_map['layer_norm_0.tmp_0']
    assert texecutor._wpg_partition(ops, main, [loss.name]) is not None
    assert texecutor._wpg_partition(ops, main, [loss.name, inter]) is None
    losses, _, final, _ = _train_port(runs['state'], runs['batch'],
                                      fetch_grad_of=['layer_norm_0.tmp_0'])
    assert losses == runs['tlosses']
    for n, v in final.items():
        assert torch.equal(v, runs['tfinal'][n]), n


def test_training_leaves_plain_tensors_in_the_scope(runs):
    """Updated parameters carry no autograd history and are no inference
    tensors, so the next step can differentiate through them."""
    for n, v in runs['tfinal'].items():
        assert not v.requires_grad and v.grad_fn is None, n
        assert not v.is_inference(), n

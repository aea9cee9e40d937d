"""BERT at seq 128 against the JAX package, on the CPU: below
flash_min_len (512, as in the JAX package) the encoder is the naive
attention chain (reshape, transpose2, matmul, the [B, 1, 1, T] key bias,
softmax, dropout, matmul), which the port now lowers.

A small BERT (2 layers, hidden 64, 4 heads, vocab 1000, max_pos 128,
hidden and attention dropout 0, whose masks draw from jax threefry in
the JAX package) at seq 128:

(a) build_pretrain's inference and training Programs serialize alike;
(b) a model dir the JAX package saved is served by the port's
    predictor (CPU) within 1e-4 of the JAX predictor, at batches 1, 3
    (bucket 4) and 8, with padded keys;
(c) 3 Adam steps in lockstep (tests/torch_attention_cases.py): each
    step's loss within rel 1e-5, each parameter after it within 1e-5,
    1% of the lr, as tests/test_torch_train_parity.py holds them (a
    step moves a parameter by lr * g / (|g| + eps), so where g is
    rounding noise around 0 — the key projection's bias — two correct
    f32 runs can move it up to lr * |dg| / eps apart; 7.2e-7 here), the
    first moments within 1e-7 and the second within 1e-9 plus rtol 1e-4
    (squares of ~1e-2 gradients);
(d) the causal chain (a causal_mask_like bias beside the key bias)
    agrees with the JAX package within 1e-5 where a padded key above
    the diagonal gets -1e9 - 10000 and a row's only unmasked key is
    padded;
(e) the naive chain agrees with the fused attention op on the same
    weights.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.inference import predictor as jpredictor
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import predictor as tpredictor
from paddle_tpu_torch.models import bert as tbert

from torch_attention_cases import (EPSILON, LR, adam_lockstep, programs,
                                   whole_program_grad)
from torch_image_cases import same_block

SEQ = 128
FEEDS = ('src_ids', 'pos_ids', 'sent_ids', 'input_mask')
NAIVE = ['reshape2', 'transpose2', 'matmul', 'elementwise_add', 'softmax',
         'matmul', 'transpose2', 'reshape2']


def _cfg(bert_mod, **kw):
    return bert_mod.BertConfig(vocab_size=1000, hidden=64, layers=2,
                               heads=4, intermediate=128, max_pos=SEQ,
                               dropout=0.0, **kw)


def _pretrain(is_test):
    def build(fluid, mod):
        feeds, enc, loss = mod.build_pretrain(_cfg(mod), SEQ,
                                              is_test=is_test)
        if is_test:
            return enc
        fluid.optimizer.Adam(learning_rate=LR, epsilon=EPSILON).minimize(loss)
        return loss
    return programs(build, jbert, tbert)


def _types(main):
    return [op.type for op in main.global_block().ops]


def _has_chain(types, chain):
    return any(types[i:i + len(chain)] == chain for i in range(len(types)))


@pytest.mark.parametrize('is_test', [True, False])
def test_pretrain_program_serializes_like_jax(is_test):
    progs = _pretrain(is_test)
    jm, js, _ = progs['jax']
    tm, ts, _ = progs['torch']
    same_block(jm.to_dict()['blocks'][0], tm.to_dict()['blocks'][0])
    same_block(js.to_dict()['blocks'][0], ts.to_dict()['blocks'][0])
    types = _types(tm)
    assert 'fused_multihead_attention' not in types
    assert types.count('matmul') == 4 and types.count('transpose2') == 8
    if not is_test:
        assert types.count('matmul_grad') == 4


@pytest.fixture(scope='module')
def jax_dir(tmp_path_factory):
    progs = _pretrain(True)
    jm, js, enc = progs['jax']
    d = str(tmp_path_factory.mktemp('jax_bert128'))
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        jfluid.io.save_inference_model(d, list(FEEDS), [enc], exe,
                                       main_program=jm)
    return d


def test_port_serves_a_jax_saved_seq128_dir(jax_dir):
    jpred = jpredictor.create_paddle_predictor(
        jpredictor.AnalysisConfig(jax_dir))
    tcfg = tpredictor.AnalysisConfig(jax_dir)
    tcfg.disable_gpu()
    tpred = tpredictor.create_paddle_predictor(tcfg)
    assert tpred.get_input_names() == list(FEEDS)
    assert _has_chain(_types(tpred._program), NAIVE)
    rng = np.random.RandomState(0)
    for b in (1, 3, 8):
        feed = tbert.encoder_batch(_cfg(tbert), b, SEQ, rng,
                                   pad_to=SEQ - 11 * b)
        inputs = [feed[n] for n in FEEDS]
        got = tpred.run(inputs)[0].data
        want = jpred.run(inputs)[0].data
        assert got.shape == (b, SEQ, 64) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module')
def lockstep():
    progs = _pretrain(False)
    rng = np.random.RandomState(1)
    feeds = [tbert.synthetic_batch(_cfg(tbert), 4, SEQ, rng)
             for _ in range(3)]
    for f in feeds:
        f['input_mask'][:, SEQ - 20:] = 0.0
    return progs, adam_lockstep(progs, feeds)


def test_adam_steps_match_jax_in_lockstep(lockstep):
    (steps, names) = lockstep[1]
    for i, step in enumerate(steps):
        jloss, _, jstate = step['jax']
        tloss, _, tstate = step['torch']
        assert np.isfinite(tloss)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=i)
        for n in names:
            if '_moment1_' in n:
                atol, rtol = 1e-7, 1e-4
            elif '_moment2_' in n:
                atol, rtol = 1e-9, 1e-4
            else:
                atol, rtol = 1e-5, 0
            np.testing.assert_allclose(tstate[n], jstate[n], atol=atol,
                                       rtol=rtol, err_msg='%s step %d'
                                       % (n, i + 1))
    moved = [n for n in names if n.endswith('.w_0') and not np.array_equal(
        steps[-1]['torch'][2][n], steps[0]['before'][n])]
    assert len(moved) == sum(n.endswith('.w_0') for n in names)


def test_training_takes_the_whole_program_grad(lockstep):
    """One autograd pass over the forward region, not the per-op grad
    ops: the naive chain's ops need no fallback."""
    tm, _, loss = lockstep[0]['torch']
    assert whole_program_grad(tm, loss) is not None


def _attention_program(fluid, mod, causal, flash_min_len=512, seq=16):
    cfg = _cfg(mod)
    cfg.flash_min_len = flash_min_len
    x = fluid.layers.data('x', shape=[seq, 64], dtype='float32')
    mask = fluid.layers.data('input_mask', shape=[seq], dtype='float32')
    key_bias = fluid.layers.scale(mask, scale=10000.0, bias=-10000.0)
    bias = fluid.layers.unsqueeze(fluid.layers.unsqueeze(key_bias, [1]),
                                  [1])
    return mod.multi_head_attention(x, bias, cfg, True, key_bias=key_bias,
                                    causal=causal)


def _attention_feed(seq=16):
    rng = np.random.RandomState(2)
    mask = np.ones((3, seq), 'float32')
    mask[0, seq - 5:] = 0.0  # padded keys, above the diagonal too
    mask[1, 0] = 0.0  # row 0's only unmasked key (itself) is padded
    return {'x': rng.randn(3, seq, 64).astype('float32'),
            'input_mask': mask}


def _run_both(progs, feed):
    outs = {}
    jm, js, jout = progs['jax']
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        state = weights.numpy_state(
            jfluid.global_scope(), [p.name for p in jm.all_parameters()])
        outs['jax'] = np.asarray(exe.run(jm, feed=feed,
                                         fetch_list=[jout])[0])
    tm, ts, tout = progs['torch']
    with tfluid.scope_guard(tfluid.Scope()):
        weights.load_numpy_params(tfluid.global_scope(), state,
                                  tfluid.CPUPlace())
        outs['torch'] = tfluid.Executor(tfluid.CPUPlace()).run(
            tm, feed=feed, fetch_list=[tout])[0]
    return outs, state


def test_causal_chain_matches_jax():
    progs = programs(lambda fluid, mod: _attention_program(
        fluid, mod, causal=True), jbert, tbert)
    tm = progs['torch'][0]
    same_block(progs['jax'][0].to_dict()['blocks'][0],
               tm.to_dict()['blocks'][0])
    assert 'causal_mask_like' in _types(tm)
    outs, _ = _run_both(progs, _attention_feed())
    assert np.isfinite(outs['torch']).all()
    np.testing.assert_allclose(outs['torch'], outs['jax'], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('causal', [False, True])
def test_naive_chain_agrees_with_the_fused_op(causal):
    """The same attention as the naive chain (flash_min_len 512) and as
    fused_multihead_attention (flash_min_len 0, its plain version on the
    CPU), on the same weights: within 1e-5."""
    feed = _attention_feed()
    got = {}
    for fml in (512, 0):
        progs = programs(lambda fluid, mod: _attention_program(
            fluid, mod, causal, flash_min_len=fml), jbert, tbert)
        assert ('fused_multihead_attention' in _types(
            progs['torch'][0])) == (fml == 0)
        got[fml] = _run_both(progs, feed)[0]['torch']
    np.testing.assert_allclose(got[512], got[0], rtol=1e-5, atol=1e-5)

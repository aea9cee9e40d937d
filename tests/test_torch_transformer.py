"""Transformer NMT training (models/transformer.py) against the JAX
package, on the CPU: the TINY widths (d_model 64, 4 heads, ffn 128,
2 + 2 layers, vocabularies of 500) at source and target length 16,
dropout 0 (its masks draw from jax threefry in the JAX package), Adam
at lr 1e-3 with epsilon 1e-6 (tests/torch_attention_cases.py).

(a) The training Programs serialize alike, with label smoothing (one_hot,
    label_smooth, soft-label softmax_with_cross_entropy, squeeze2) and
    without (the hard-label route through unsqueeze2 and squeeze2);
(b) 3 steps in lockstep on bucket-padded ragged batches, then one step
    of a shorter bucket (8) on the same Program: each loss within rel
    1e-5; every parameter's gradient within 1e-6 plus rtol 1e-4 (f32
    sums in other orders put them ~4e-8 apart here; the key
    projections' biases have gradients that are mathematically 0, so
    no relative bound holds for them); every parameter after the step
    within 1e-5, 1% of the lr, for the reason tests/test_torch_bert128.py
    gives (2.9e-7 here);
(c) the step takes the whole-program grad: one autograd pass, with the
    position encodings and the causal bias cut from the graph.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.models import transformer as ttr

from torch_attention_cases import (EPSILON, LR, adam_lockstep, programs,
                                   whole_program_grad)
from torch_image_cases import same_block

LEN = 16
BATCH = 4


def _cfg(mod):
    return mod.TransformerConfig(src_vocab=500, tgt_vocab=500, d_model=64,
                                 heads=4, ffn=128, enc_layers=2,
                                 dec_layers=2, dropout=0.0, max_len=64)


def _programs(eps):
    def build(fluid, mod):
        _, _, loss = mod.build(_cfg(mod), src_len=LEN, tgt_len=LEN,
                               label_smooth_eps=eps)
        fluid.optimizer.Adam(learning_rate=LR, epsilon=EPSILON).minimize(loss)
        return loss
    return programs(build, jtr, ttr)


def _feeds(n, length=LEN, seed=0):
    rng = np.random.RandomState(seed)
    return [ttr.synthetic_batch(_cfg(ttr), BATCH, length, length, rng)
            for _ in range(n)]


def _types(main):
    return [op.type for op in main.global_block().ops]


@pytest.mark.parametrize('eps', [0.1, 0.0])
def test_program_serializes_like_jax(eps):
    progs = _programs(eps)
    for i in (0, 1):
        same_block(progs['jax'][i].to_dict()['blocks'][0],
                   progs['torch'][i].to_dict()['blocks'][0])
    types = _types(progs['torch'][0])
    assert types.count('position_encoding') == 2
    assert types.count('causal_mask_like') == 1
    assert types.count('matmul') == 2 * (2 + 2 * 2)
    soft = ['one_hot', 'label_smooth', 'softmax_with_cross_entropy',
            'squeeze2']
    assert all(t in types for t in soft) == bool(eps)
    if not eps:
        i = types.index('softmax_with_cross_entropy')
        assert types[i - 1] == 'unsqueeze2' and types[i + 1] == 'squeeze2'


def test_synthetic_batch_is_the_jax_packages():
    want = jtr.synthetic_batch(_cfg(jtr), BATCH, LEN, 12,
                               np.random.RandomState(3))
    got = ttr.synthetic_batch(_cfg(ttr), BATCH, LEN, 12,
                              np.random.RandomState(3))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _check_steps(steps, names, params):
    for i, step in enumerate(steps):
        jloss, jgrads, jstate = step['jax']
        tloss, tgrads, tstate = step['torch']
        assert np.isfinite(tloss)
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=i)
        for p, g, w in zip(params, tgrads, jgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg='%s step %d' % (p, i + 1))
        for n in params:
            np.testing.assert_allclose(tstate[n], jstate[n], rtol=0,
                                       atol=1e-5,
                                       err_msg='%s step %d' % (n, i + 1))


@pytest.fixture(scope='module')
def smoothed():
    progs = _programs(0.1)
    params = [p.name for p in progs['torch'][0].all_parameters()]
    feeds = _feeds(3) + _feeds(1, length=8, seed=1)
    steps, names = adam_lockstep(progs, feeds, grad_of=params)
    return progs, steps, names, params


def test_label_smoothed_steps_match_jax(smoothed):
    _, steps, names, params = smoothed
    _check_steps(steps[:3], names, params)
    # 2 embeddings; 6 attentions of 4 fc layers, 4 ffns of 2 (weight and
    # bias each); the head; 10 layer norms' scales and shifts
    assert len(params) == 2 + 6 * 4 * 2 + 4 * 2 * 2 + 2 + 10 * 2


def test_shorter_bucket_step_on_the_same_program(smoothed):
    """Step 4 feeds length-8 batches to the Program built for 16: the
    position encodings and the causal bias size themselves from it."""
    _, steps, names, params = smoothed
    _check_steps(steps[3:], names, params)
    assert steps[3]['torch'][1][0].shape == (500, 64)


def test_hard_label_steps_match_jax():
    progs = _programs(0.0)
    params = [p.name for p in progs['torch'][0].all_parameters()]
    steps, names = adam_lockstep(progs, _feeds(2, seed=2), grad_of=params)
    _check_steps(steps, names, params)


def test_steps_take_the_whole_program_grad(smoothed):
    tm, _, loss = smoothed[0]['torch']
    plan = whole_program_grad(tm, loss)
    assert plan is not None
    made = {op.output_arg_names[0] for op in tm.global_block().ops
            if op.type in ('position_encoding', 'causal_mask_like')}
    assert len(made) == 3 and made <= plan['stop']


def test_dropout_trains_with_fresh_masks_each_step():
    """At the BASE dropout of 0.1 (hidden and attention probabilities)
    the port's steps give finite losses that differ from the same steps
    without dropout, and the same step number replays the same masks."""
    def run(dropout, steps):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 5
        cfg = _cfg(ttr)
        cfg.dropout = dropout
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            _, _, loss = ttr.build(cfg, src_len=LEN, tgt_len=LEN)
            tfluid.optimizer.Adam(learning_rate=LR).minimize(loss)
        feed = _feeds(1)[0]
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            return [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                    for _ in range(steps)], \
                _types(main).count('dropout')
    (a, n_drop), (b, _), (c, n_none) = run(0.1, 2), run(0.1, 2), run(0.0, 2)
    assert n_drop == 2 + 2 * 2 + 2 * 3 and n_none == 0
    assert np.isfinite(a).all() and a == b
    assert a[0] != c[0]

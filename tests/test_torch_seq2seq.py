"""Phase 15's LSTM seq2seq (models/seq2seq.py) at TINY widths (2 layers,
hidden 16, embeddings 12, vocabularies 40 and 30, beam 3), batch 4,
source length 7 and target length 5, on the CPU against the JAX
package:

(a) the training program and both decode programs serialize alike, op
    for op, in both packages (the While's sub-block included);
(b) 3 Adam steps (lr 1e-3, global-norm clip 5.0, dropout 0) in lockstep
    (each step from the JAX package's state, weights.load_numpy_params;
    torch_attention_cases.adam_lockstep): each loss within rel 1e-5,
    every parameter's gradient within 1e-6 plus rtol 1e-4 (f32 sums over
    the masked trips in another order), every parameter after the step
    within 1e-6 (1e-3 of the lr: Adam's first steps move each
    parameter by about lr);
(c) the step takes the whole-program grad (one autograd pass through
    the masked loop) and may be captured in a CUDA graph; the plan
    cache's steps are bitwise the uncached ones;
(d) the decodes from the JAX package's startup state give the same ids
    and parents, bitwise;
(e) the synthetic ids follow Zipf's law, so eos is not the most
    frequent target token (a model that learns the counts would else
    end every beam at its first steps).
"""

import numpy as np

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import seq2seq

from torch_attention_cases import adam_lockstep
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

CFG = seq2seq.TINY
B, S, T = 4, 7, 5
LR = 1e-3


def _train(fluid):
    loss = seq2seq.build_train(fluid, CFG, B, S, T)
    fluid.optimizer.Adam(
        learning_rate=LR,
        grad_clip=fluid.clip.GradientClipByGlobalNorm(5.0)).minimize(loss)
    return loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [seq2seq.synthetic_batch(CFG, B, S, T, rng) for _ in range(n)]


def test_programs_serialize_like_jax():
    for build in (_train,
                  lambda f: seq2seq.build_beam_decode(f, CFG, B, S),
                  lambda f: seq2seq.build_while_decode(f, CFG, B, S)):
        progs = build_both(build)
        same_program(progs['jax'][0], progs['torch'][0])
    train = build_both(_train)['torch'][0]
    ops = [op.type for op in train.global_block().ops]
    assert ops.count('while') == 1 and ops.count('while_grad') == 1
    assert ops.count('lstm') == 2 and ops.count('dropout') == 0


def test_three_adam_steps_match_jax():
    progs = build_both(_train)
    params = sorted(p.name for p in progs['torch'][0].all_parameters())
    steps, _ = adam_lockstep(progs, _feeds(3), grad_of=params)
    for i, step in enumerate(steps):
        jloss, jgrads, jstate = step['jax']
        tloss, tgrads, tstate = step['torch']
        np.testing.assert_allclose(tloss, jloss, rtol=1e-5, err_msg=i)
        for p, g, w in zip(params, tgrads, jgrads):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg='%s step %d' % (p, i + 1))
        for n in params:
            np.testing.assert_allclose(tstate[n], jstate[n], rtol=0,
                                       atol=1e-6,
                                       err_msg='%s step %d' % (n, i + 1))


def test_step_plan_is_the_whole_program_grad_and_capturable():
    main, _, loss = build_both(_train)['torch']
    plan = texecutor._build_plan(main, [loss.name])
    assert plan.kind == 'wpg' and plan.no_graph is None
    loop = [op for op in main.global_block().ops if op.type == 'while'][0]
    assert loop.attrs['__needs_grad__'] and \
        loop.attrs['max_trip_count'] == T + 1
    # the four decoder states, the summed loss, the counter, the condition
    assert len(loop.attrs['__carry_names__']) == 2 * CFG.layers + 3


def test_plan_cache_steps_bitwise_uncached():
    main, startup, loss = build_both(_train)['torch']
    names = weights.startup_names(startup)
    feeds = _feeds(3, seed=1)
    runs = []
    for cache in (False, True):
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            if runs:
                weights.load_numpy_params(tfluid.global_scope(),
                                          runs[0]['start'],
                                          tfluid.CPUPlace(), startup)
            start = weights.numpy_state(tfluid.global_scope(), names)
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              use_program_cache=cache)[0] for f in feeds]
            runs.append({'start': start, 'losses': losses,
                         'after': weights.numpy_state(tfluid.global_scope(),
                                                      names)})
    for a, b in zip(runs[0]['losses'], runs[1]['losses']):
        np.testing.assert_array_equal(a, b)
    for n in names:
        np.testing.assert_array_equal(runs[0]['after'][n],
                                      runs[1]['after'][n], err_msg=n)


def test_decodes_match_jax():
    train = build_both(_train)
    feed = _feeds(1, seed=2)[0]
    feed = {'src': feed['src'], 'src_len': feed['src_len']}
    for build in (seq2seq.build_beam_decode, seq2seq.build_while_decode):
        progs = build_both(lambda f: list(build(f, CFG, B, S)))
        both = {k: (progs[k][0], train[k][1], progs[k][2]) for k in progs}
        out = run_both(both, [feed])
        assert_runs_close(out, 1e-5)


def test_synthetic_ids_follow_zipf():
    feed = seq2seq.synthetic_batch(seq2seq.BASE, 128, 50, 50,
                                   np.random.RandomState(0))
    for key, vocab in (('src', seq2seq.BASE.src_vocab),
                       ('tgt_out', seq2seq.BASE.tgt_vocab)):
        ids = feed[key][feed[key] > 0]
        counts = np.bincount(ids, minlength=vocab)
        assert ids.max() < vocab and (ids >= 1).all()
        # p(id) ~ 1 / (id - 1): id 2 about twice id 3's count
        assert counts[2] > 1.5 * counts[3] > 0
        assert counts[2] == counts[2:].max()
    tgt = feed['tgt_out']
    eos = np.bincount(tgt[tgt > 0])[seq2seq.BASE.eos]
    assert eos == 128 and np.bincount(tgt[tgt > 0])[2] > 3 * eos

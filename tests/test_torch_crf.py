"""The CRF pair and chunk_eval (ops/lang_ops.py) and the book's
label_semantic_roles (models/label_semantic_roles.py) on the CPU
against the JAX package:

(a) linear_chain_crf's cost, Alpha (log-domain) and the exps within
    rtol 1e-5, its gradients within 1e-5 (torch.autograd over the
    port's batched recursion against jax.vjp over the JAX package's
    lax.scan; torch_attention_cases.check), and the cost against a
    brute force over every tag path (as the JAX package's
    tests/test_lang_ops.py:46-108 does), at lengths full, partial, 1
    and 0;
(b) crf_decoding's paths bitwise, with and without Label, with ties
    (a constant emission) taking the first maximum, and against the
    brute force's best path;
(c) chunk_eval's six outputs exactly for the four schemes, with
    excluded chunk types;
(d) the JAX package's test_book_lang.py::test_label_semantic_roles_crf
    program through both packages: 10 Adam steps within rtol 1e-5 (loss
    and decoded paths; each step from the same state, in lockstep);
(e) label_semantic_roles at TINY: the training program and its eval
    clone (crf_decoding + chunk_eval) serialize alike, 3 SGD steps in
    lockstep within rtol 1e-5, the eval program's paths bitwise and its
    chunk counts equal; the bucketed loader's batches equal the JAX
    loader's on the same samples and a numpy padding of them; the
    synthetic samples' lengths and labels are as the model says.
"""

import itertools

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.ops import lang_ops

from torch_attention_cases import adam_lockstep, check, close
from torch_image_cases import run_jax, run_torch
from torch_program_cases import build_both, same_program

TOL = 1e-5
B, T, D = 4, 6, 4
LENGTHS = np.array([[6], [3], [1], [0]], 'int64')


def _crf_inputs(seed=0):
    r = np.random.RandomState(seed)
    return {'Emission': [r.randn(B, T, D).astype('float32')],
            'Transition': [r.randn(D + 2, D).astype('float32')],
            'Label': [r.randint(0, D, (B, T)).astype('int64')],
            'Length': [LENGTHS]}


def _score(x, trans, path):
    s = trans[0, path[0]] + trans[1, path[-1]] + x[0, path[0]]
    for k in range(1, len(path)):
        s += trans[2 + path[k - 1], path[k]] + x[k, path[k]]
    return s


def _brute(x, trans, n):
    """(-log-likelihood of every path, best path) over the first n
    positions, by enumeration."""
    paths = list(itertools.product(range(D), repeat=n))
    scores = np.array([_score(x, trans, p) for p in paths], 'float64')
    return scores, paths[int(np.argmax(scores))]


def test_crf_cost_alpha_and_gradients_match_jax():
    ins = _crf_inputs()
    check('linear_chain_crf', ins, {}, TOL, TOL)
    ins['Label'] = [ins['Label'][0][..., None]]   # [B, T, 1] labels
    check('linear_chain_crf', ins, {}, TOL, TOL)


def test_crf_cost_against_brute_force():
    ins = _crf_inputs(1)
    ins['Length'] = [np.array([[6], [3], [1], [2]], 'int64')]
    got = run_torch('linear_chain_crf', ins, {})['LogLikelihood'][0][:, 0]
    x, trans = ins['Emission'][0], ins['Transition'][0]
    for b in range(B):
        n = int(ins['Length'][0][b, 0])
        scores, _ = _brute(x[b], trans, n)
        label = tuple(ins['Label'][0][b, :n])
        log_z = np.log(np.exp(scores - scores.max()).sum()) + scores.max()
        want = log_z - _score(x[b], trans, label)
        np.testing.assert_allclose(got[b], want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize('with_label', [False, True])
def test_viterbi_paths_bitwise(with_label):
    ins = _crf_inputs(2)
    if not with_label:
        ins.pop('Label')
    want = run_jax('crf_decoding', ins, {})['ViterbiPath'][0]
    got = run_torch('crf_decoding', ins, {})['ViterbiPath'][0]
    np.testing.assert_array_equal(got, want)
    if with_label:
        return
    x, trans = ins['Emission'][0], ins['Transition'][0]
    for b in range(B):
        n = int(LENGTHS[b, 0])
        if n:
            assert tuple(got[b, :n]) == _brute(x[b], trans, n)[1]
        assert not got[b, n:].any()


def test_viterbi_ties_take_the_first_maximum():
    ins = {'Emission': [np.zeros((2, 5, 3), 'float32')],
           'Transition': [np.zeros((5, 3), 'float32')],
           'Length': [np.array([[5], [2]], 'int64')]}
    want = run_jax('crf_decoding', ins, {})['ViterbiPath'][0]
    got = run_torch('crf_decoding', ins, {})['ViterbiPath'][0]
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def _chunk_case(scheme, num_types, seed):
    r = np.random.RandomState(seed)
    n_tags = lang_ops._CHUNK_SCHEMES[scheme][0]
    n_labels = num_types * n_tags + 1
    infer = r.randint(0, n_labels, (5, 12)).astype('int64')
    label = np.where(r.rand(5, 12) < 0.6, infer,
                     r.randint(0, n_labels, (5, 12))).astype('int64')
    return infer, label, np.array([12, 7, 1, 0, 9], 'int64')


def _chunk_eval(fluid, infer, label, lengths, attrs):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        i = fluid.layers.data('i', shape=list(infer.shape), dtype='int64',
                              append_batch_size=False)
        lab = fluid.layers.data('l', shape=list(infer.shape),
                                dtype='int64', append_batch_size=False)
        n = fluid.layers.data('n', shape=[infer.shape[0]], dtype='int64',
                              append_batch_size=False)
        outs = fluid.layers.chunk_eval(i, lab, seq_length=n, **attrs)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        return [np.asarray(v) for v in exe.run(
            main, feed={'i': infer, 'l': label, 'n': lengths},
            fetch_list=list(outs))]


@pytest.mark.parametrize('scheme', ['IOB', 'IOE', 'IOBES', 'plain'])
def test_chunk_eval_matches_jax_exactly(scheme):
    for excluded in ([], [1]):
        infer, label, lengths = _chunk_case(scheme, 3, len(scheme))
        attrs = {'chunk_scheme': scheme, 'num_chunk_types': 3,
                 'excluded_chunk_types': excluded}
        want = _chunk_eval(jfluid, infer, label, lengths, attrs)
        got = _chunk_eval(tfluid, infer, label, lengths, attrs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.reshape(w.shape), w)
        assert got[3][0] > 0 and got[5][0] > 0


def _book_crf(fluid):
    """tests/test_book_lang.py::test_label_semantic_roles_crf's program."""
    vocab, emb_dim, hid, n_tags, t = 60, 16, 16, 5, 12
    words = fluid.layers.data('words', shape=[t], dtype='int64')
    target = fluid.layers.data('target', shape=[t], dtype='int64')
    length = fluid.layers.data('length', shape=[1], dtype='int64')
    mask = fluid.layers.data('mask', shape=[t], dtype='float32')
    emb = fluid.layers.embedding(words, size=[vocab, emb_dim])
    proj = fluid.layers.fc(emb, size=4 * hid, num_flatten_dims=2)
    hidden, _ = fluid.layers.dynamic_lstm(proj, size=4 * hid, mask=mask)
    emission = fluid.layers.fc(hidden, size=n_tags, num_flatten_dims=2)
    crf_attr = fluid.ParamAttr(name='crfw')
    cost = fluid.layers.linear_chain_crf(emission, target,
                                         param_attr=crf_attr, length=length)
    loss = fluid.layers.mean(cost)
    fluid.optimizer.Adam(5e-3).minimize(loss)
    decoded = fluid.layers.crf_decoding(emission, crf_attr, length=length)
    return loss, decoded


def _book_batches(n, size=16, t=12, vocab=60, n_tags=5):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        w = rng.randint(0, vocab, (size, t)).astype('int64')
        lens = rng.randint(3, t + 1, size)
        out.append({'words': w, 'target': (w % n_tags).astype('int64'),
                    'length': lens[:, None].astype('int64'),
                    'mask': (np.arange(t)[None] < lens[:, None]).astype(
                        'float32')})
    return out


def _lockstep(progs, feeds, extra):
    """Each step's loss, `extra` fetches and whole state in both
    packages, every step from the JAX package's state before it."""
    jm, js, (jl, jx) = progs['jax']
    tm, ts, (tl, tx) = progs['torch']
    names = weights.startup_names(ts)
    steps = []
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        for feed in feeds:
            before = weights.numpy_state(jfluid.global_scope(), names)
            out = exe.run(jm, feed=feed, fetch_list=[jl, jx] + extra)
            steps.append((before, [np.asarray(v) for v in out],
                          weights.numpy_state(jfluid.global_scope(), names)))
    place = tfluid.CPUPlace()
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(place)
        exe.run(ts)
        for feed, (before, want, want_state) in zip(feeds, steps):
            weights.load_numpy_params(tfluid.global_scope(), before, place,
                                      ts)
            got = exe.run(tm, feed=feed, fetch_list=[tl, tx] + extra)
            close(got[0].reshape(want[0].shape), want[0], TOL, 'loss')
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_array_equal(g.reshape(w.shape), w)
            state = weights.numpy_state(tfluid.global_scope(), names)
            for n in names:
                close(state[n], want_state[n], TOL, n)
    return [float(np.asarray(s[1][0]).ravel()[0]) for s in steps]


def test_book_crf_program_trains_like_jax():
    progs = build_both(_book_crf, seed=11)
    same_program(progs['jax'][0], progs['torch'][0])
    losses = _lockstep(progs, _book_batches(10), [])
    assert losses[-1] < losses[0]


def _srl_train(fluid):
    _, loss, decode = srl.build_train(fluid, srl.TINY)
    return loss, decode


def _srl_feeds(n, seed=0, boundary=16):
    samples = srl.synthetic_samples(srl.TINY, seed, n * srl.TINY.batch,
                                    max_len=boundary)
    return [srl.pad_batch(samples[i:i + srl.TINY.batch], boundary)
            for i in range(0, len(samples), srl.TINY.batch)]


def test_srl_tiny_serializes_and_trains_like_jax():
    progs = build_both(_srl_train, seed=7)
    same_program(progs['jax'][0], progs['torch'][0])
    # each clone is built under a fresh unique_name generator: outside a
    # guard its chunk_eval names would carry whatever count an earlier
    # test left in that package's global generator
    evals = {}
    for k, f in (('jax', jfluid), ('torch', tfluid)):
        with f.unique_name.guard():
            evals[k] = srl.build_eval(f, srl.TINY, progs[k][0],
                                      progs[k][2][1])
    same_program(evals['jax'][0], evals['torch'][0])
    types = [op.type for op in progs['torch'][0].global_block().ops]
    assert types.count('lookup_table_v2') == 8 and \
        types.count('lstm') == srl.TINY.depth
    feeds = _srl_feeds(3)
    _lockstep(progs, feeds, [])
    # the eval clone on held-out batches from the JAX startup state
    held = _srl_feeds(1, seed=5)[0]
    out = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        test, outs = evals[key]
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(progs['jax'][1] if key == 'jax' else progs['torch'][1])
            if key == 'jax':
                state = weights.numpy_state(
                    jfluid.global_scope(),
                    weights.startup_names(progs['torch'][1]))
            else:
                weights.load_numpy_params(tfluid.global_scope(), state,
                                          tfluid.CPUPlace(),
                                          progs['torch'][1])
            out[key] = [np.asarray(v) for v in exe.run(
                test, feed=held, fetch_list=[progs[key][2][1]] + outs)]
    for g, w in zip(out['torch'], out['jax']):
        np.testing.assert_array_equal(g.reshape(w.shape), w)
    counts = lang_ops.chunk_counts(out['torch'][0], held['target'],
                                   held['length'].ravel(), 'IOB',
                                   srl.TINY.chunk_types)
    assert tuple(int(v[0]) for v in out['torch'][4:]) == counts


def test_bucketed_loader_batches_match_jax_and_numpy():
    samples = srl.synthetic_samples(srl.TINY, 3, 40, max_len=30)
    boundaries = [8, 16, 32]
    got = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            feeds = srl.feed_vars(fluid)
        loader = fluid.io.DataLoader.from_generator(
            feed_list=feeds, bucket_boundaries=boundaries,
            batch_size=srl.TINY.batch, drop_last=True, use_double_buffer=False)
        loader.set_sample_generator(lambda: iter(samples),
                                    places=fluid.CPUPlace())
        got[key] = [{k: np.asarray(v) for k, v in b.items()}
                    for b in loader]
    assert len(got['jax']) == len(got['torch']) >= 3
    buckets = {b: [] for b in boundaries}
    want = []
    for s in samples:
        b = min(x for x in boundaries if x >= len(s[0]))
        buckets[b].append(s)
        if len(buckets[b]) == srl.TINY.batch:
            want.append(srl.pad_batch(buckets[b], b))
            buckets[b] = []
    for j, t, w in zip(got['jax'], got['torch'], want):
        assert set(t) == set(w) == set(j)
        for k in w:
            np.testing.assert_array_equal(t[k], w[k].reshape(t[k].shape))
            np.testing.assert_array_equal(np.asarray(j[k]).astype(
                t[k].dtype).reshape(t[k].shape), t[k])
    # the loader's batch feeds the TINY model as its numpy padding does
    losses = []
    for feed in (got['torch'][0], want[0]):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 7
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            _, loss, _ = srl.build_train(tfluid, srl.TINY)
        with tfluid.scope_guard(tfluid.Scope()):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            losses.append(exe.run(main, feed=feed, fetch_list=[loss])[0])
    assert np.isfinite(losses[0]).all() and np.array_equal(*losses)


def test_synthetic_samples():
    cfg = srl.BASE
    samples = srl.synthetic_samples(cfg, 0, 2000)
    lengths = np.array([s[-1][0] for s in samples])
    assert lengths.min() >= 4 and lengths.max() <= 100
    assert 20 < lengths.mean() < 30
    labels = np.concatenate([s[8] for s in samples])
    assert labels.min() >= 0 and labels.max() == srl.labels(cfg) - 1
    for s in samples[:50]:
        assert all(len(f) == s[-1][0] for f in s[:-1])
        assert sum(s[7]) in (3, 4, 5)


def test_two_level_lod_feed_into_a_sequence_op_raises_like_jax():
    """A LoDTensor feed of two levels that reaches the LSTM (through the
    embedding and the fc) raises in both packages and names the op; one
    level runs."""
    feed = _book_batches(1)[0]
    out = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss, _ = _book_crf(fluid)
        nested = dict(feed, words=fluid.LoDTensor(feed['words'],
                                                  [[0, 8, 16], [0] + [
                                                      12] * 16]))
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            with pytest.raises(RuntimeError, match=r'2-level LoD.*\[lstm\]'):
                exe.run(main, feed=nested, fetch_list=[loss])
            flat = dict(feed, words=fluid.LoDTensor(feed['words'],
                                                    [[0] + [12] * 16]))
            out[key] = exe.run(main, feed=flat, fetch_list=[loss])[0]
    assert np.isfinite(out['torch']).all()

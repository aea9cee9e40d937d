"""The sampling losses and cos_sim (ops/lang_ops.py: nce,
hierarchical_sigmoid, sample_logits, cos_sim) and their layers on the
CPU against the JAX package.  The JAX ops draw from jax threefry, which
PyTorch cannot reproduce, so a draw is held by statistics and the
losses by the JAX package's formulas evaluated (in jax.numpy) on the
port's own samples:

- the three nce samplers: a chi-square test of 20,000 draws against
  each sampler's distribution (p = 0.001), the draws a function of the
  seed, the op's seed attr and the step (a second run is bitwise the
  first, another step draws otherwise); the cost, the sample logits and
  the gradients within rtol 1e-5 of the JAX formula on the port's
  samples (nce_op.h; the log-uniform probability in its log1p form);
- hierarchical_sigmoid against the JAX op (forward 1e-5, gradients
  1e-5), num_classes a power of two among them, and 32768, where a
  float log2 of the path code is off by one;
- sample_logits within rtol 1e-5 of the JAX formula on the port's
  samples: -log Q, the -1e20 on accidental hits, uniq off;
- cos_sim against the JAX op, Y [B, D] and [1, D] broadcast; the
  JAX package's test_book_lang.py::test_recommender_system_cos_sim
  program trained 5 Adam steps in both packages (rtol 1e-5);
- the nce, hsigmoid and sampled_softmax_with_cross_entropy layers build
  the JAX package's programs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops import registry as treg

from torch_attention_cases import check, close
from torch_program_cases import (assert_runs_close, build_both, run_both,
                                 same_program)

TOL = 1e-5
V, D, BATCH = 20, 8, 16


def _run(op, ins, attrs, step=1, grad=False, seed=0):
    ctx = treg.LowerCtx(step=step, op_seed=3, device='cpu', random_seed=9)
    tins = {s: [torch.as_tensor(a) for a in v] for s, v in ins.items()}
    xs = [x.requires_grad_() for v in tins.values() for x in v
          if x.is_floating_point()] if grad else []
    with torch.enable_grad():
        outs = treg.get(op).run(ctx, tins, attrs)
        grads = []
        if grad:
            cost = outs['Cost' if op == 'nce' else 'SampledLogits'][0]
            ct = torch.as_tensor(np.random.RandomState(seed).randn(
                *cost.shape).astype('float32'))
            grads = [g.numpy() for g in torch.autograd.grad(cost, xs, ct)]
    return {s: [v.detach().numpy() for v in vs] for s, vs in outs.items()}, \
        grads


def _nce_ins(seed=0, v=V, b=BATCH, num_true=1):
    r = np.random.RandomState(seed)
    return {'Input': [r.randn(b, D).astype('float32')],
            'Weight': [r.randn(v, D).astype('float32')],
            'Bias': [r.randn(v).astype('float32')],
            'Label': [r.randint(0, v, (b, num_true)).astype('int64')]}


def _sampler_p(sampler, v, custom=None):
    k = np.arange(v)
    if sampler == 'uniform':
        return np.full(v, 1.0 / v)
    if sampler == 'log_uniform':
        return np.log((k + 2.0) / (k + 1.0)) / np.log(v + 1.0)
    return np.asarray(custom) / np.sum(custom)


CUSTOM = list(np.random.RandomState(7).dirichlet(np.ones(V)))


def _attrs(sampler, num_neg=10):
    a = {'num_neg_samples': num_neg, 'sampler': sampler, 'seed': 2,
         'num_total_classes': V}
    if sampler == 'custom_dist':
        a['custom_dist'] = CUSTOM
    return a


@pytest.mark.parametrize('sampler', ['uniform', 'log_uniform',
                                     'custom_dist'])
def test_nce_samplers_by_chi_square(sampler):
    from scipy import stats
    ins = _nce_ins(b=2000)
    out, _ = _run('nce', ins, _attrs(sampler))
    neg = out['SampleLabels'][0][:, 1:].ravel()
    counts = np.bincount(neg, minlength=V)
    expected = _sampler_p(sampler, V, CUSTOM) * neg.size
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < stats.chi2.ppf(0.999, V - 1), (chi2, counts, expected)
    again, _ = _run('nce', ins, _attrs(sampler))
    np.testing.assert_array_equal(again['SampleLabels'][0],
                                  out['SampleLabels'][0])
    other, _ = _run('nce', ins, _attrs(sampler), step=2)
    assert not np.array_equal(other['SampleLabels'][0],
                              out['SampleLabels'][0])


def _jax_nce(x, w, bias, label, neg, sampler, v, num_neg):
    """The JAX package's nce cost (ops/lang_ops.py:357-423) given the
    negatives."""
    if sampler == 'uniform':
        def p_of(ids):
            return jnp.full(ids.shape, 1.0 / v, jnp.float32)
    elif sampler == 'log_uniform':
        def p_of(ids):
            return (jnp.log1p(1.0 / (ids.astype(jnp.float32) + 1.0)) /
                    np.log(v + 1.0)).astype(jnp.float32)
    else:
        dist = jnp.asarray(np.asarray(CUSTOM, np.float32))
        dist = dist / jnp.sum(dist)

        def p_of(ids):
            return dist[ids]

    def logits_of(ids):
        return jnp.einsum('bkd,bd->bk', w[ids], x) + bias[ids]

    z_true = logits_of(label) - jnp.log(num_neg * p_of(label))
    z_neg = logits_of(neg) - jnp.log(num_neg * p_of(neg))
    cost = (jnp.sum(jax.nn.softplus(-z_true), 1) +
            jnp.sum(jax.nn.softplus(z_neg), 1)) / label.shape[1]
    return cost[:, None], jnp.concatenate([z_true, z_neg], 1)


@pytest.mark.parametrize('sampler', ['uniform', 'log_uniform',
                                     'custom_dist'])
def test_nce_cost_matches_the_jax_formula_on_its_samples(sampler):
    ins = _nce_ins(1, num_true=2)
    attrs = _attrs(sampler)
    out, grads = _run('nce', ins, attrs, grad=True)
    neg = out['SampleLabels'][0][:, 2:]
    np.testing.assert_array_equal(out['SampleLabels'][0][:, :2],
                                  ins['Label'][0])
    args = [jnp.asarray(ins[s][0]) for s in ('Input', 'Weight', 'Bias')]

    def f(x, w, b):
        return _jax_nce(x, w, b, jnp.asarray(ins['Label'][0]),
                        jnp.asarray(neg), sampler, V, 10)
    (cost, logits), vjp = jax.vjp(f, *args)
    close(out['Cost'][0], np.asarray(cost), TOL, 'Cost')
    close(out['SampleLogits'][0], np.asarray(logits), TOL, 'SampleLogits')
    ct = np.random.RandomState(0).randn(*cost.shape).astype('float32')
    want = vjp((jnp.asarray(ct), jnp.zeros_like(logits)))
    for g, w in zip(grads, want):
        close(g, np.asarray(w), TOL, 'gradient')


@pytest.mark.parametrize('num_classes', [6, 8, 16, 1000, 32768])
def test_hsigmoid_matches_jax(num_classes):
    r = np.random.RandomState(num_classes)
    labels = r.randint(0, num_classes, BATCH)
    labels[:2] = [0, num_classes - 1]
    check('hierarchical_sigmoid',
          {'X': [r.randn(BATCH, 4).astype('float32')],
           'W': [r.randn(num_classes - 1, 4).astype('float32') * 0.5],
           'Bias': [r.randn(num_classes - 1).astype('float32')],
           'Label': [labels.astype('int64')]},
          {'num_classes': num_classes}, TOL, TOL)


def _jax_sample_logits(logits, labels, samples, k, nt, uniq=True,
                       remove=True):
    """The JAX package's sample_logits (ops/lang_ops.py:534-566) given
    the samples."""
    logq = jnp.log((jnp.log(samples + 2.0) - jnp.log(samples + 1.0)) /
                   jnp.log(k + 1.0))
    sampled = jnp.take_along_axis(logits, samples, axis=1)
    if not uniq:
        logq = jnp.zeros_like(logq)
    sampled = sampled - logq.astype(sampled.dtype)
    hit = (samples[:, nt:, None] == labels[:, None, :]).any(-1)
    if remove:
        sampled = sampled.at[:, nt:].add(
            jnp.where(hit, -1e20, 0.0).astype(sampled.dtype))
    return sampled, jnp.exp(logq)


@pytest.mark.parametrize('attrs', [{}, {'uniq': False},
                                   {'remove_accidental_hits': False}])
def test_sample_logits_matches_the_jax_formula_on_its_samples(attrs):
    r = np.random.RandomState(2)
    n, k, nt, s = 12, 30, 2, 16
    logits = r.randn(n, k).astype('float32')
    labels = r.randint(0, 6, (n, nt)).astype('int64')
    attrs = dict(attrs, num_samples=s)
    out, grads = _run('sample_logits', {'Logits': [logits],
                                        'Labels': [labels]}, attrs,
                      grad=True)
    samples = out['Samples'][0]
    np.testing.assert_array_equal(samples[:, :nt], labels)
    assert (samples[:, nt:] == samples[:1, nt:]).all()
    assert ((samples >= 0) & (samples < k)).all()
    want, probs = _jax_sample_logits(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(samples), k,
        nt, attrs.get('uniq', True), attrs.get('remove_accidental_hits',
                                               True))
    close(out['SampledLogits'][0], np.asarray(want), TOL, 'SampledLogits')
    close(out['Probabilities'][0], np.asarray(probs), TOL, 'Probabilities')
    np.testing.assert_array_equal(out['SampledLabels'][0],
                                  np.tile(np.arange(nt), (n, 1)))
    if attrs.get('remove_accidental_hits', True):
        assert (out['SampledLogits'][0] < -1e19).any()
    # the gradient goes to the sampled columns, duplicates summed
    ct = np.random.RandomState(0).randn(n, nt + s).astype('float32')
    want_g = np.zeros_like(logits)
    for row in range(n):
        np.add.at(want_g[row], samples[row], ct[row])
    close(grads[0], want_g, TOL, 'gradient')


@pytest.mark.parametrize('y_rows', [BATCH, 1])
def test_cos_sim_matches_jax(y_rows):
    r = np.random.RandomState(y_rows)
    x = r.randn(BATCH, D).astype('float32')
    check('cos_sim', {'X': [x], 'Y': [r.randn(y_rows, D).astype('float32')]},
          {}, TOL, TOL)


def _recommender(fluid):
    """test_book_lang.py::test_recommender_system_cos_sim's program."""
    n_users, n_items, dim = 30, 40, 16
    uid = fluid.layers.data('uid', shape=[1], dtype='int64')
    mid = fluid.layers.data('mid', shape=[1], dtype='int64')
    rating = fluid.layers.data('rating', shape=[1], dtype='float32')
    uemb = fluid.layers.embedding(uid, size=[n_users, dim])
    memb = fluid.layers.embedding(mid, size=[n_items, dim])
    uvec = fluid.layers.fc(fluid.layers.reshape(uemb, [-1, dim]), 32,
                           act='relu')
    mvec = fluid.layers.fc(fluid.layers.reshape(memb, [-1, dim]), 32,
                           act='relu')
    sim = fluid.layers.cos_sim(uvec, mvec)
    pred = fluid.layers.scale(sim, scale=5.0)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, rating))
    fluid.optimizer.Adam(1e-2).minimize(loss)
    return [loss, pred]


def test_recommender_cos_sim_program_trains_like_jax():
    progs = build_both(_recommender, seed=13)
    same_program(progs['jax'][0], progs['torch'][0])
    rng = np.random.RandomState(2)
    true_u, true_m = rng.randn(30, 4), rng.randn(40, 4)
    feeds = []
    for _ in range(5):
        u = rng.randint(0, 30, (32, 1)).astype('int64')
        m = rng.randint(0, 40, (32, 1)).astype('int64')
        r = np.clip((true_u[u[:, 0]] * true_m[m[:, 0]]).sum(1), -5, 5)
        feeds.append({'uid': u, 'mid': m,
                      'rating': r[:, None].astype('float32')})
    out = run_both(progs, feeds)
    assert_runs_close(out, 1e-4)


def _sampling_layers(fluid):
    layers = fluid.layers
    x = layers.data('x', shape=[D], dtype='float32')
    label = layers.data('label', shape=[1], dtype='int64')
    nce = layers.nce(x, label, num_total_classes=V, num_neg_samples=5,
                     sampler='log_uniform', seed=4)
    hs = layers.hsigmoid(x, label, num_classes=V)
    logits = layers.fc(x, size=V)
    ssm = layers.sampled_softmax_with_cross_entropy(logits, label, 6)
    cos = layers.cos_sim(x, layers.fc(x, size=D))
    return [layers.mean(nce), layers.mean(hs), layers.mean(ssm), cos]


def test_sampling_layers_build_the_jax_programs():
    progs = build_both(_sampling_layers)
    same_program(progs['jax'][0], progs['torch'][0])
    r = np.random.RandomState(0)
    feed = {'x': r.randn(4, D).astype('float32'),
            'label': r.randint(0, V, (4, 1)).astype('int64')}
    out = run_both(progs, [feed])
    # hsigmoid and cos_sim draw nothing: equal to the JAX package's
    close(out['torch'][0][1], out['jax'][0][1], TOL, 'hsigmoid')
    close(out['torch'][0][3], out['jax'][0][3], TOL, 'cos_sim')
    assert all(np.isfinite(v).all() for v in out['torch'][0])

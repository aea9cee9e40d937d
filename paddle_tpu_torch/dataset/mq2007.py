"""MQ2007 learning-to-rank loader (reference python/paddle/dataset/
mq2007.py: pointwise/pairwise/listwise generators over 46-dim query-doc
features). Zero-egress: seeded synthetic queries whose relevance is a
noisy linear function of the features, so rankers have signal."""

import numpy as np

FEATURE_DIM = 46


def _make_queries(n_queries, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(11).randn(FEATURE_DIM)
    for _ in range(n_queries):
        n_docs = rng.randint(5, 20)
        feats = rng.rand(n_docs, FEATURE_DIM).astype('float32')
        score = feats @ w + rng.randn(n_docs) * 0.1
        rel = np.digitize(score, np.percentile(score, [50, 80]))
        yield feats, rel.astype('int64')


def gen_point(n_queries=100, seed=5):
    def reader():
        for feats, rel in _make_queries(n_queries, seed):
            for f, r in zip(feats, rel):
                yield int(r), f
    return reader


def gen_pair(n_queries=100, seed=5, partial_order='full'):
    def reader():
        rng = np.random.RandomState(seed + 1)
        for feats, rel in _make_queries(n_queries, seed):
            n = len(rel)
            for i in range(n):
                for j in range(n):
                    if rel[i] > rel[j]:
                        if partial_order != 'full' and \
                                rng.rand() > 0.3:
                            continue  # sampled subset of pairs
                        yield 1.0, feats[i], feats[j]
    return reader


def gen_list(n_queries=100, seed=5):
    def reader():
        for feats, rel in _make_queries(n_queries, seed):
            yield rel.tolist(), feats
    return reader


def train(format='pairwise'):
    return {'pointwise': gen_point, 'pairwise': gen_pair,
            'listwise': gen_list}[format](100, 5)


def test(format='pairwise'):
    return {'pointwise': gen_point, 'pairwise': gen_pair,
            'listwise': gen_list}[format](20, 6)


def fetch():
    pass

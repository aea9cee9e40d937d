"""IMDB sentiment loader (reference python/paddle/dataset/imdb.py API:
word_dict(), train(word_dict), test(word_dict))."""

import numpy as np

_VOCAB = 5000


def word_dict():
    return {('w%d' % i).encode(): i for i in range(_VOCAB)}


def _synthetic(n, seed):
    """Sequences whose sentiment is carried by marker tokens, so a real
    classifier is learnable."""
    rng = np.random.RandomState(seed)
    pos_markers = list(range(10, 30))
    neg_markers = list(range(30, 50))
    for _ in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(20, 120))
        seq = rng.randint(50, _VOCAB, length)
        markers = pos_markers if label else neg_markers
        idx = rng.choice(length, size=max(2, length // 10),
                         replace=False)
        seq[idx] = rng.choice(markers, size=len(idx))
        yield seq.tolist(), label


def train(word_idx=None):
    def reader():
        for s in _synthetic(1024, 0):
            yield s
    return reader


def test(word_idx=None):
    def reader():
        for s in _synthetic(256, 1):
            yield s
    return reader

"""NLTK movie-review sentiment loader (reference
python/paddle/dataset/sentiment.py API: get_word_dict/train/test).
Zero-egress: seeded synthetic reviews with class-separable vocabulary.
"""

import numpy as np

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 5000


def get_word_dict():
    """word -> id, reference sorts by frequency."""
    return {('word_%d' % i): i for i in range(_VOCAB)}


def _reader(start, end, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(start, end):
            label = i % 2
            # positive reviews sample low ids, negative high ids
            base = 0 if label == 0 else _VOCAB // 2
            words = (base + rng.randint(0, _VOCAB // 2,
                                        size=rng.randint(20, 120)))
            yield words.tolist(), label
    return reader


def train():
    return _reader(0, NUM_TRAINING_INSTANCES, 7)


def test():
    return _reader(NUM_TRAINING_INSTANCES, NUM_TOTAL_INSTANCES, 8)


def fetch():
    pass

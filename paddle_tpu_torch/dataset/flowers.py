"""Oxford-102 flowers loader (reference python/paddle/dataset/flowers.py
API): train()/test()/valid() yield (3x224x224 float32 image in [-1,1],
int label).

Reads pre-extracted npz shards from $PADDLE_TPU_DATA_HOME/flowers when
present; otherwise serves deterministic synthetic images with
class-dependent structure (zero-egress image: no download path).
"""

import os

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')
N_CLASSES = 102


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        label = int(rng.randint(0, N_CLASSES))
        img = rng.randn(3, 224, 224).astype('float32') * 0.1
        ch = label % 3
        r, c = divmod((label // 3) % 16, 4)
        img[ch, 16 + r * 48:48 + r * 48, 16 + c * 48:48 + c * 48] += 1.0
        yield img, label


def _reader(split, n_synth, seed, mapper=None, cycle=False):
    def one_pass():
        p = os.path.join(_HOME, 'flowers', split + '.npz') \
            if _HOME else None
        if p and os.path.exists(p):
            d = np.load(p)
            for img, label in zip(d['images'], d['labels']):
                yield img.astype('float32'), int(label)
        else:
            yield from _synthetic(n_synth, seed)

    def reader():
        while True:
            for rec in one_pass():
                yield mapper(rec) if mapper is not None else rec
            if not cycle:
                return
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader('train', 256, 31, mapper=mapper, cycle=cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _reader('test', 64, 32, mapper=mapper, cycle=cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader('valid', 64, 33)

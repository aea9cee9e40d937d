"""CIFAR loader (reference python/paddle/dataset/cifar.py API).

Yields (flattened float32 image in [-1, 1] of length 3072, int label).
Reads the pickled batches from $PADDLE_TPU_DATA_HOME/cifar when
present; otherwise serves deterministic synthetic data with
class-dependent color patches so models have signal to learn
(zero-egress image: no download path).
"""

import os
import pickle
import tarfile

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')


def _local(name):
    return os.path.join(_HOME, 'cifar', name) if _HOME else None


def _synthetic(n, n_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, n).astype('int64')
    imgs = rng.randn(n, 3, 32, 32).astype('float32') * 0.1
    # every class gets a distinct deterministic template so all
    # n_classes (up to 100) stay statistically separable
    tmpl_rng = np.random.RandomState(97)
    templates = tmpl_rng.randn(n_classes, 3, 32, 32).astype('float32')
    templates /= np.abs(templates).max(axis=(1, 2, 3), keepdims=True)
    for i, l in enumerate(labels):
        imgs[i] += templates[int(l)]
    return imgs.reshape(n, -1), labels


def _tar_reader(path, member_match, n_classes):
    with tarfile.open(path) as tar:
        for m in tar.getmembers():
            if member_match not in m.name:
                continue
            d = pickle.load(tar.extractfile(m), encoding='bytes')
            key = b'labels' if b'labels' in d else b'fine_labels'
            for img, label in zip(d[b'data'], d[key]):
                yield img.astype('float32') / 127.5 - 1.0, int(label)


def _reader(archive, member_match, n_classes, n_synth, seed):
    def reader():
        p = _local(archive)
        if p and os.path.exists(p):
            yield from _tar_reader(p, member_match, n_classes)
        else:
            imgs, labels = _synthetic(n_synth, n_classes, seed)
            for img, label in zip(imgs, labels):
                yield img, int(label)
    return reader


def train10():
    return _reader('cifar-10-python.tar.gz', 'data_batch', 10, 1024, 10)


def test10():
    return _reader('cifar-10-python.tar.gz', 'test_batch', 10, 256, 11)


def train100():
    return _reader('cifar-100-python.tar.gz', 'train', 100, 1024, 12)


def test100():
    return _reader('cifar-100-python.tar.gz', 'test', 100, 256, 13)

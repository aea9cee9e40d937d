"""MNIST reader (reference python/paddle/dataset/mnist.py API).

The idx files are read from $PADDLE_TPU_DATA_HOME/mnist when they are
there (nothing is downloaded); otherwise the readers yield
``_synthetic`` samples: a seeded numpy draw, bitwise the JAX package's
(paddle_tpu/dataset/mnist.py), in which each digit 0-9 lights its own
6 x 6 block of the 28 x 28 image over noise of std 0.1.  Images are
float32 [784] in [-1, 1] (read) or around [0, 1] (synthetic), labels
int.
"""

import gzip
import os
import struct

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')


def _local_path(name):
    return os.path.join(_HOME, 'mnist', name) if _HOME else None


def _read_idx_images(path):
    with gzip.open(path, 'rb') as f:
        _, n, rows, cols = struct.unpack('>IIII', f.read(16))
        data = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    return data.astype('float32') / 127.5 - 1.0


def _read_idx_labels(path):
    with gzip.open(path, 'rb') as f:
        struct.unpack('>II', f.read(8))
        return np.frombuffer(f.read(), np.uint8).astype('int64')


def _synthetic(n, seed):
    """(images [n, 784] float32, labels [n] int64) from `seed`."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype('int64')
    imgs = rng.randn(n, 784).astype('float32') * 0.1
    for i, label in enumerate(labels):
        r, c = divmod(int(label), 4)
        block = np.zeros((28, 28), 'float32')
        block[4 + r * 6:10 + r * 6, 2 + c * 6:8 + c * 6] = 1.0
        imgs[i] += block.reshape(-1)
    return imgs, labels


def _reader(images_file, labels_file, n_synth, seed):
    def reader():
        p = _local_path(images_file)
        if p and os.path.exists(p):
            imgs = _read_idx_images(p)
            labels = _read_idx_labels(_local_path(labels_file))
        else:
            imgs, labels = _synthetic(n_synth, seed)
        for img, label in zip(imgs, labels):
            yield img, int(label)
    return reader


def train():
    """Reader of (image [784] float32, label int): the idx training set,
    or 2048 synthetic samples from seed 0."""
    return _reader('train-images-idx3-ubyte.gz',
                   'train-labels-idx1-ubyte.gz', 2048, 0)


def test():
    """The idx test set, or 512 synthetic samples from seed 1."""
    return _reader('t10k-images-idx3-ubyte.gz',
                   't10k-labels-idx1-ubyte.gz', 512, 1)

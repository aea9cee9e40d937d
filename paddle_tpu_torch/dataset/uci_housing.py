"""UCI housing loader (reference python/paddle/dataset/uci_housing.py)."""

import os

import numpy as np

feature_names = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE',
                 'DIS', 'RAD', 'TAX', 'PTRATIO', 'B', 'LSTAT']

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')


def _load():
    path = os.path.join(_HOME, 'uci_housing', 'housing.data') \
        if _HOME else None
    if path and os.path.exists(path):
        data = np.loadtxt(path)
    else:
        # synthetic linear-ish housing data, fixed seed
        rng = np.random.RandomState(42)
        X = rng.rand(506, 13).astype('float32')
        w = rng.randn(13, 1).astype('float32')
        y = X @ w + 0.1 * rng.randn(506, 1).astype('float32')
        data = np.concatenate([X, y], axis=1)
    feats = data[:, :-1].astype('float32')
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    target = data[:, -1:].astype('float32')
    return feats, target


def train():
    def reader():
        X, y = _load()
        for i in range(int(len(X) * 0.8)):
            yield X[i], y[i]
    return reader


def test():
    def reader():
        X, y = _load()
        for i in range(int(len(X) * 0.8), len(X)):
            yield X[i], y[i]
    return reader

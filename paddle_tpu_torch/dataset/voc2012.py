"""VOC2012 segmentation loader (reference python/paddle/dataset/
voc2012.py API: train/test/val yielding (image, label-mask)).
Zero-egress: seeded synthetic images with blob masks."""

import numpy as np


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            h, w = 128, 128
            img = (rng.rand(3, h, w) * 255).astype('float32')
            label = np.zeros((h, w), 'int32')
            cls = rng.randint(1, 21)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            label[y0:y0 + h // 3, x0:x0 + w // 3] = cls
            yield img, label
    return reader


def train():
    return _reader(128, 1)


def test():
    return _reader(32, 2)


def val():
    return _reader(32, 3)

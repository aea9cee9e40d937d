"""Image preprocessing utilities (reference python/paddle/dataset/
image.py): resize/crop/flip/chw transforms over numpy arrays (the
reference shells out to cv2; numpy keeps this dependency-free), as the
JAX package's paddle_tpu/dataset/image.py computes them.  The random
transforms draw from `rng`, a numpy RandomState, or the global numpy
generator where none is given (the JAX module's draws)."""

import numpy as np


def _to_float(im):
    return np.asarray(im, 'float32')


def resize_short(im, size):
    """Resize so the shorter edge == size (nearest-neighbor)."""
    im = _to_float(im)
    h, w = im.shape[:2]
    scale = size / float(min(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = np.clip((np.arange(nh) / scale).astype(int), 0, h - 1)
    xs = np.clip((np.arange(nw) / scale).astype(int), 0, w - 1)
    return im[ys][:, xs]


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    y = max((h - size) // 2, 0)
    x = max((w - size) // 2, 0)
    return im[y:y + size, x:x + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = np.random if rng is None else rng
    h, w = im.shape[:2]
    y = rng.randint(0, max(h - size, 0) + 1)
    x = rng.randint(0, max(w - size, 0) + 1)
    return im[y:y + size, x:x + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None, rng=None):
    rng = np.random if rng is None else rng
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if rng.randint(2):
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = _to_float(im)
    if mean is not None:
        mean = np.asarray(mean, 'float32')
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean.reshape(-1, 1, 1)  # per-channel over CHW
        im -= mean
    return im

"""Serving-plane row padding and slicing.  Reference: the JAX package's
fluid/serving.py; the batching ServingExecutor comes with ROADMAP
Queue 1 item 16."""

import numpy as np


def pad_rows_to_bucket(feed, rows, bucket):
    """Pad every batch-aligned feed's leading dim from `rows` to
    `bucket` with zero rows.  Feeds whose leading dim is not `rows`
    (scalars, per-model side inputs) pass through untouched.  Returns
    (padded_feed, pad_waste_bytes)."""
    if rows == bucket:
        return feed, 0.0
    out = {}
    waste = 0.0
    for name, v in feed.items():
        a = np.asarray(v)
        if a.ndim and a.shape[0] == rows:
            padded = np.zeros((bucket,) + a.shape[1:], a.dtype)
            padded[:rows] = a
            out[name] = padded
            waste += float(padded.nbytes - a.nbytes)
        else:
            out[name] = a
    return out, waste


def slice_rows(val, off, n, bucket):
    """One request's rows of a batched fetch.  Outputs that do not
    carry the bucket's batch dim (scalars, whole-batch aggregates) are
    returned whole."""
    a = np.asarray(val)
    if a.ndim and a.shape[0] == bucket:
        return a[off:off + n]
    return a

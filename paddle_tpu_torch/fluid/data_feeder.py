"""DataFeeder: convert python/numpy minibatch rows into feed arrays.

Reference: python/paddle/fluid/data_feeder.py (JAX:
fluid/data_feeder.py).  The arrays stay numpy on the host: the
executor (or a DataLoader's double buffer) moves them to the card.
Unlike the JAX package, int64 columns keep their width.
"""

import numpy as np

from . import core


class DataFeeder(object):
    def __init__(self, feed_list, place, program=None):
        from . import framework
        self.place = place
        program = program or framework.default_main_program()
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_vars.append(v)

    def feed(self, iterable):
        rows = list(iterable)
        result = {}
        for i, var in enumerate(self.feed_vars):
            cols = [r[i] for r in rows]
            arr = np.asarray(cols).astype(core.dtype_name(var.dtype))
            # align trailing dims to the var spec (e.g. label [N] -> [N,1])
            want = list(var.shape)
            if len(want) == arr.ndim + 1 and want[-1] == 1:
                arr = arr[..., None]
            result[var.name] = arr
        return result

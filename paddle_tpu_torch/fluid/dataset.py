"""Dataset API over the native MultiSlot feeder (JAX: fluid/dataset.py).

Reference: python/paddle/fluid/dataset.py (DatasetFactory:22,
InMemoryDataset:276, QueueDataset:646) configuring the C++
MultiSlotDataFeed / Dataset (framework/data_feed.h:532,
framework/data_set.h:41).

The native feeder (paddle_tpu_torch/runtime, datafeed.cc) parses and
batches off the GIL; batches arrive as {name: CPU tensor} padded to the
use_vars' shapes, in pinned host memory wherever CUDA is available, so
the executor's copy to the card reads the feeder's own buffers.  One
process reads every file: global_shuffle is the local shuffle.
"""

import numpy as np
import torch


class DatasetBase(object):
    def __init__(self):
        self.batch_size = 1
        self.filelist = []
        self.use_vars = []
        self.thread_num = 4
        self.shuffle_buffer = 0
        self.seed = 0
        self._pipe_command = 'cat'

    # -- reference config surface ----------------------------------------
    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_thread(self, thread_num):
        self.thread_num = thread_num

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self._pipe_command = pipe_command

    def set_hdfs_config(self, fs_name, fs_ugi):
        pass

    def _slots(self):
        slots = []
        for v in self.use_vars:
            dim = int(np.prod([d for d in v.shape if d > 0])) or 1
            if v.dtype in ('int64', 'int32'):
                slots.append((v.name, 'sparse', dim))
            else:
                slots.append((v.name, 'dense', dim))
        return slots

    def _feeder(self):
        from ..runtime import MultiSlotDataFeed
        return MultiSlotDataFeed(self.filelist, self._slots(),
                                 self.batch_size, self.thread_num,
                                 self.shuffle_buffer, self.seed,
                                 pin=torch.cuda.is_available())

    def _shaped(self, raw):
        """A feeder batch as feeds shaped to the use_vars."""
        out = {}
        for v in self.use_vars:
            arr = raw[v.name]
            out[v.name] = arr.reshape([arr.shape[0]] + [
                d for d in v.shape[1:] if d > 0])
        return out

    def batches(self):
        """Yield feed dicts shaped to the use_vars."""
        feeder = self._feeder()
        try:
            for raw in feeder:
                yield self._shaped(raw)
        finally:
            feeder.close()


class QueueDataset(DatasetBase):
    """Streaming dataset (reference dataset.py:646)."""


class InMemoryDataset(DatasetBase):
    """Load-then-shuffle dataset (reference dataset.py:276).  The shuffle
    permutes the loaded batches with numpy's RandomState(seed), the JAX
    package's order."""

    def __init__(self):
        super(InMemoryDataset, self).__init__()
        self._memory = None

    def load_into_memory(self):
        self._memory = []
        feeder = self._feeder()
        try:
            for raw in feeder:
                self._memory.append(raw)
        finally:
            feeder.close()

    def local_shuffle(self):
        rng = np.random.RandomState(self.seed)
        if self._memory is None:
            self.shuffle_buffer = 4096
            return
        rng.shuffle(self._memory)

    def global_shuffle(self, fleet=None):
        # one process reads every file: the local shuffle
        self.local_shuffle()

    def release_memory(self):
        self._memory = None

    def get_memory_data_size(self, fleet=None):
        return sum(int(next(iter(b.values())).shape[0])
                   for b in (self._memory or []))

    def batches(self):
        if self._memory is None:
            for b in super(InMemoryDataset, self).batches():
                yield b
            return
        for raw in self._memory:
            yield self._shaped(raw)


class DatasetFactory(object):
    """Reference: dataset.py:22."""

    def create_dataset(self, datafeed_class='QueueDataset'):
        if datafeed_class == 'InMemoryDataset':
            return InMemoryDataset()
        if datafeed_class in ('QueueDataset', 'MultiSlotDataFeed'):
            return QueueDataset()
        raise ValueError('unknown dataset class %s' % datafeed_class)

"""DataLoader. Reference: python/paddle/fluid/reader.py —
DataLoader.from_generator(:75) feeding a LoDTensorBlockingQueue(:298),
DataLoader.from_dataset(:261) over the Dataset runtime, double-buffered
to the device by operators/reader/buffered_reader.cc (JAX:
fluid/reader.py).

The port's pipeline (``_AsyncBatchIterator``): a producer thread drains
the user generator into a bounded host queue (`capacity`, the
LoDTensorBlockingQueue); the consumer keeps `stage_depth` batches staged
ahead on the card.  Staging copies each field into pinned host memory
(fields the native feeder already wrote there are used as they are) and
from there to the card on a side CUDA stream, with an event a batch;
the batch handed out makes the consumer's current stream wait on that
event (``wait_event``: no host synchronize) and ``record_stream`` keeps
its memory alive for the work queued there.  So the next batches' copies
overlap the current step, as buffered_reader.cc's double buffer.  Every
blocking put and get waits with a timeout and looks again, so a stopped
pipeline is never waited on for ever.  The pipeline counts
``reader/batches_produced`` and ``batches_consumed``, the host queue's
depth (``reader/queue_depth``), ``reader/bytes_staged``, and the
consumer's wait on an empty window (``reader/consume_blocked_seconds``
and the ``reader_wait`` span), as the JAX package's does
(fluid/reader.py:80-158).

The LoD-replacement front end lives here too: BucketedGeneratorLoader
groups genuinely ragged samples into a small set of padded shapes
(length bucketing), so the executor sees one feed signature, and one
CUDA graph, per bucket; the serving plane shares the bucket ladder.
"""

import queue as _queue
import threading
import time

import numpy as np
import torch

from . import core
from . import monitor
from . import trace as _trace

_WAIT_S = 0.05  # a blocking put/get looks at the stop flag this often


class _AsyncBatchIterator(object):
    """Background-thread prefetch over a batch generator: the
    LoDTensorBlockingQueue + buffered_reader pair.

    The host queue holds up to `capacity` batches; the device window
    stages only `stage_depth` (default 2, buffered_reader.cc's depth) of
    them onto `device`, a torch CUDA device (None or a CPU device:
    nothing is staged), so capacity bounds host memory, not device
    memory.  Fields in `stage_exclude` stay on the host.

    Producer exceptions re-raise at the consumer's next(), after the
    batches queued before them; exhaustion is sticky (every later
    next() raises StopIteration again); close() (or GC) stops the
    producer without draining the generator."""

    _END = object()

    def __init__(self, gen, capacity, device=None, stage_depth=2,
                 stage_exclude=()):
        self._q = _queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._exc = None
        self._device = device if device is not None and \
            torch.device(device).type == 'cuda' else None
        self._stream = None if self._device is None else \
            torch.cuda.Stream(self._device)
        self._stage_exclude = frozenset(stage_exclude)
        self._staged = []
        self._stage_depth = max(1, int(stage_depth))
        self._done = False
        self._thread = threading.Thread(
            target=self._work, args=(gen,), daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_WAIT_S)
                return True
            except _queue.Full:
                continue
        return False

    def _work(self, gen):
        try:
            for batch in gen():
                if not self._put(batch):
                    return
                # producer-side accounting (LoDTensorBlockingQueue stats;
                # JAX: fluid/reader.py:80): batches entering the host
                # queue, and its depth right after the put
                monitor.add('reader/batches_produced')
                monitor.set_gauge('reader/queue_depth', self._q.qsize())
        except BaseException as e:  # noqa: B036 — must cross threads
            self._exc = e
        finally:
            self._put(self._END)

    def _get(self, block):
        """The next queued item; None when nothing is queued and `block`
        is false.  A producer that died without its end marker ends the
        iteration."""
        while True:
            try:
                return self._q.get(block=block, timeout=_WAIT_S) if block \
                    else self._q.get_nowait()
            except _queue.Empty:
                if not block:
                    return None
                if not self._thread.is_alive() and self._q.empty():
                    return self._END

    def _stage(self, batch):
        """(batch with its fields on the card, the event its copies
        record), or (batch, None) when nothing is staged."""
        if self._device is None:
            return batch, None
        out = {}
        nbytes = 0.0
        t0 = time.perf_counter()
        with torch.cuda.stream(self._stream):
            for k, v in batch.items():
                v = core.as_array(v)
                if k in self._stage_exclude or (
                        isinstance(v, torch.Tensor) and v.is_cuda):
                    out[k] = v
                    continue
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.ascontiguousarray(v))
                if not v.is_pinned():
                    v = v.contiguous().pin_memory()
                nbytes += float(v.numel() * v.element_size())
                out[k] = v.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        if nbytes:
            # the copies are queued, not waited for: the span is their
            # host cost (pinning, submission)
            monitor.add('reader/bytes_staged', nbytes)
            _trace.record('reader_h2d', t0, time.perf_counter(),
                          {'nbytes': nbytes})
        return out, event

    def _fill_window(self):
        while not self._done and len(self._staged) < self._stage_depth:
            # an empty window waits for the producer (the time the step
            # loop loses to input: reader_wait); a non-empty one only
            # tops up what is already queued
            if self._staged:
                item = self._get(block=False)
            else:
                t0 = time.perf_counter()
                item = self._get(block=True)
                t1 = time.perf_counter()
                monitor.observe('reader/consume_blocked_seconds', t1 - t0)
                _trace.record('reader_wait', t0, t1)
            if item is None:
                return
            if item is self._END:
                self._done = True
                self._stop.set()
                return
            self._staged.append(self._stage(item))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill_window()
        if not self._staged:
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        batch, event = self._staged.pop(0)
        monitor.add('reader/batches_consumed')
        monitor.set_gauge('reader/queue_depth', self._q.qsize())
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(current)
        self._fill_window()  # keep the copies ahead of the compute
        return batch

    next = __next__

    def close(self):
        self._stop.set()
        self._done = True
        self._staged = []
        # unblock a producer parked on a full queue
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:
            pass


def pow2_bucket_ladder(max_size, start=1):
    """Power-of-two bucket boundaries covering sizes up to `max_size`:
    [start, 2*start, ...] ending at the first power >= max_size.  The
    ladder the bucketed loader applies to sequence LENGTHS and the
    serving plane applies to BATCH rows: O(log max) feed signatures,
    one CUDA graph each."""
    out = []
    b = max(1, int(start))
    top = max(1, int(max_size))
    while b < top:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def bucket_for(size, boundaries):
    """The smallest boundary >= `size` (the BucketedGeneratorLoader
    rule, shared with the predictor's batch buckets).  `boundaries` must
    be sorted ascending."""
    for b in boundaries:
        if size <= b:
            return int(b)
    raise ValueError(
        'size %d exceeds the largest bucket boundary %d'
        % (size, boundaries[-1]))


def mask_name(name, mask_map=None):
    """The '@MASK' companion-feed convention: the mask feed name for a
    padded field."""
    if mask_map:
        return mask_map.get(name, name + '@MASK')
    return name + '@MASK'


class DataLoader(object):
    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, bucket_boundaries=None,
                       batch_size=None, mask_map=None, drop_last=False,
                       ragged_fields=None, stage_exclude=None):
        """bucket_boundaries + batch_size turn the loader into the
        bucketing front end for variable-length data (see
        BucketedGeneratorLoader)."""
        if bucket_boundaries is not None:
            if not batch_size:
                raise ValueError('bucketed DataLoader needs batch_size')
            return BucketedGeneratorLoader(
                feed_list, bucket_boundaries, batch_size,
                mask_map=mask_map, drop_last=drop_last,
                capacity=capacity, iterable=iterable,
                ragged_fields=ragged_fields,
                use_double_buffer=use_double_buffer,
                stage_exclude=stage_exclude)
        return GeneratorLoader(feed_list, capacity, iterable,
                               use_double_buffer=use_double_buffer,
                               stage_exclude=stage_exclude)

    @staticmethod
    def from_dataset(dataset, places, drop_last=True):
        """Iterate the Dataset runtime's batches (reference
        reader.py:261 DatasetLoader; the native feeder inside
        fluid.dataset does the file IO)."""
        return DatasetLoader(dataset, places, drop_last)


class DatasetLoader(object):
    """Reference: reader.py:261, an iterable view over a
    fluid.DatasetFactory dataset (QueueDataset/InMemoryDataset).  With
    drop_last a batch shorter than the first is skipped (one feed
    signature)."""

    def __init__(self, dataset, places, drop_last=True):
        self._dataset = dataset
        self._places = places
        self._drop_last = drop_last
        self._iter = None

    def _batches(self):
        full = None
        for feed in self._dataset.batches():
            if self._drop_last:
                n = min(int(v.shape[0]) for v in feed.values())
                if full is None:
                    full = n
                elif n < full:
                    continue
            yield feed

    def __iter__(self):
        return iter(self._batches())

    def start(self):
        self._iter = iter(self._batches())

    def next(self):
        return next(self._iter)

    def reset(self):
        self._iter = iter(self._batches())


def _place_device(places):
    """The torch device of the first of `places` (a place or a list of
    them); None (no staging) for the CPU.  No place means this rank's
    card, as the Executor's default."""
    place = places[0] if isinstance(places, (list, tuple)) and places \
        else places
    if place is None:
        from ..distributed import launch
        place = core.CUDAPlace(launch.local_card())
    dev = place.torch_device()
    return dev if dev.type == 'cuda' else None


class GeneratorLoader(object):
    def __init__(self, feed_list, capacity=64, iterable=True,
                 use_double_buffer=True, stage_exclude=None):
        """stage_exclude: feed names the double buffer leaves on the
        host (fields only host ops read)."""
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._iterable = iterable
        self._use_double_buffer = use_double_buffer
        self._stage_exclude = frozenset(stage_exclude or ())
        self._generator = None
        self._places = None
        self._iter = None
        self._live_iter = None

    def _target_device(self):
        """The CUDA device the double buffer stages onto (the first
        place given to set_*_generator), or None."""
        if not self._use_double_buffer:
            return None
        return _place_device(self._places)

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batched():
            batch = []
            for sample in reader():
                batch.append(sample)
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch and not drop_last:
                yield batch
        return self.set_sample_list_generator(batched, places)

    def set_sample_list_generator(self, reader, places=None):
        from .data_feeder import DataFeeder
        self._places = places
        feeder = DataFeeder(self._feed_list, places)

        def gen():
            for batch in reader():
                yield feeder.feed(batch)
        self._generator = gen
        return self

    def set_batch_generator(self, reader, places=None):
        self._places = places

        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {v.name: a if isinstance(a, torch.Tensor)
                           else np.asarray(a)
                           for v, a in zip(self._feed_list, batch)}
        self._generator = gen
        return self

    def _make_iter(self):
        if self._generator is None:
            raise RuntimeError('DataLoader: call set_*_generator first')
        # one live pipeline per loader: an abandoned earlier iteration
        # (early break) is closed here, its thread and staged batches
        # released
        if self._live_iter is not None:
            self._live_iter.close()
        it = _AsyncBatchIterator(self._generator, self._capacity,
                                 self._target_device(),
                                 stage_exclude=self._stage_exclude)
        self._live_iter = it
        return it

    def __iter__(self):
        return self._make_iter()

    def start(self):
        self._iter = self._make_iter()

    def next(self):
        return next(self._iter)

    def reset(self):
        if self._iter is not None:
            self._iter.close()
        self._iter = self._make_iter()


class BucketedGeneratorLoader(GeneratorLoader):
    """Length-bucketing loader for genuinely ragged samples.

    Each sample is a tuple aligned with feed_list; ragged fields (feed
    vars with lod_level > 0, or those named in ragged_fields) are padded
    to the sample's bucket boundary, the smallest boundary >= the
    sample's longest ragged field.  Batches are emitted per bucket once
    batch_size samples of that bucket accumulate, so the executor sees
    at most len(bucket_boundaries) feed signatures.  For every ragged
    field a float mask [B, T] is emitted under mask_map[name] (default
    '<name>@MASK')."""

    def __init__(self, feed_list, bucket_boundaries, batch_size,
                 mask_map=None, drop_last=False, capacity=64,
                 iterable=True, ragged_fields=None,
                 use_double_buffer=True, stage_exclude=None):
        super(BucketedGeneratorLoader, self).__init__(
            feed_list, capacity, iterable,
            use_double_buffer=use_double_buffer,
            stage_exclude=stage_exclude)
        self.boundaries = sorted(int(b) for b in bucket_boundaries)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._mask_map = dict(mask_map or {})
        if ragged_fields is None:
            self._ragged = [getattr(v, 'lod_level', 0) > 0
                            for v in self._feed_list]
        else:
            ragged_fields = set(ragged_fields)
            self._ragged = [v.name in ragged_fields
                            for v in self._feed_list]
        if not any(self._ragged):
            raise ValueError(
                'bucketed DataLoader: no ragged fields; mark feed vars '
                'with lod_level>0 or pass ragged_fields=[names]')

    def _bucket_of(self, length):
        try:
            return bucket_for(length, self.boundaries)
        except ValueError:
            raise ValueError(
                'sample length %d exceeds the largest bucket boundary '
                '%d' % (length, self.boundaries[-1]))

    def _pad_batch(self, samples, boundary):
        out = {}
        for i, var in enumerate(self._feed_list):
            col = [s[i] for s in samples]
            if not self._ragged[i]:
                out[var.name] = np.asarray(col)
                continue
            dtype = core.dtype_name(var.dtype)
            first = np.asarray(col[0])
            tail_shape = first.shape[1:]
            b = len(col)
            padded = np.zeros((b, boundary) + tail_shape, dtype)
            mask = np.zeros((b, boundary), 'float32')
            for r, seq in enumerate(col):
                seq = np.asarray(seq, dtype)
                padded[r, :len(seq)] = seq
                mask[r, :len(seq)] = 1.0
            out[var.name] = padded
            out[mask_name(var.name, self._mask_map)] = mask
        return out

    def set_sample_list_generator(self, reader, places=None):
        raise NotImplementedError(
            'bucketed DataLoader consumes per-SAMPLE generators (it '
            'forms the batches itself, one bucket at a time): use '
            'set_sample_generator')

    def set_batch_generator(self, reader, places=None):
        raise NotImplementedError(
            'bucketed DataLoader consumes per-SAMPLE generators (it '
            'forms the batches itself, one bucket at a time): use '
            'set_sample_generator')

    def set_sample_generator(self, reader, batch_size=None,
                             drop_last=None, places=None):
        if batch_size is not None:
            self.batch_size = batch_size
        if drop_last is not None:
            self.drop_last = drop_last
        self._places = places

        def gen():
            buckets = {b: [] for b in self.boundaries}
            for sample in reader():
                longest = max(
                    len(np.asarray(sample[i]))
                    for i in range(len(self._feed_list))
                    if self._ragged[i])
                b = self._bucket_of(longest)
                buckets[b].append(sample)
                if len(buckets[b]) == self.batch_size:
                    yield self._pad_batch(buckets[b], b)
                    buckets[b] = []
            if not self.drop_last:
                for b, rest in buckets.items():
                    if rest:
                        yield self._pad_batch(rest, b)
        self._generator = gen
        return self


class PyReader(GeneratorLoader):
    """Reference: python/paddle/fluid/reader.py:588 PyReader, the legacy
    decorate_* reader surface over the GeneratorLoader path."""

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        super(PyReader, self).__init__(
            feed_list, capacity, iterable,
            use_double_buffer=use_double_buffer)
        self._return_list = return_list
        self._started = False

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)

    @property
    def feed_vars(self):
        return self._feed_list

    def start(self):
        self._started = True
        self._iter = self._make_iter()

    def reset(self):
        self._started = False
        if self._iter is not None:
            self._iter.close()
        self._iter = None

    def next(self):
        if not self._started:
            raise RuntimeError('call PyReader.start() first')
        try:
            return next(self._iter)
        except StopIteration:
            self.reset()
            raise

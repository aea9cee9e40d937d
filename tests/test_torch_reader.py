"""The port's readers (fluid/reader.py, fluid/data_feeder.py,
layers.py_reader, paddle_tpu_torch/reader) against the JAX package's,
on the CPU.

Batches are compared bitwise (as numpy arrays; the JAX side reads its
device arrays back) for DataLoader.from_generator with and without the
double buffer, the sample and sample-list generators through
DataFeeder, PyReader's decorate_* surface, layers.py_reader and the
bucketed loader's padded batches and masks.  One documented difference:
an int64 column stays int64 in the port (the JAX package runs with x64
off and gives int32), so those compare as values.  The pipeline's
semantics are held as the JAX package's tests hold its own: order,
capacity, sticky exhaustion, a producer's error re-raised at the
consumer, an early break, an abandoned iteration closed by the next.
On the CPU nothing is staged (the card-only staging tests are in
test_torch_cuda_data.py).  The reader decorators give the JAX
package's samples in the JAX package's order (shuffle from the same
`random` seed).
"""

import random
import threading
import time

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader

import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.fluid.reader import _AsyncBatchIterator


def _feeds(fluid, lod_level=0):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[4], dtype='float32',
                              lod_level=lod_level)
        y = fluid.layers.data('y', shape=[1], dtype='int64')
    return main, [x, y]


def _batches(n=6):
    rng = np.random.RandomState(0)
    return [{'x': rng.randn(3, 4).astype('float32'),
             'y': rng.randint(0, 9, (3, 1)).astype('int64')}
            for _ in range(n)]


def _samples(n=11):
    rng = np.random.RandomState(1)
    return [(rng.randn(4).astype('float32'), int(rng.randint(0, 9)))
            for _ in range(n)]


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def _same(tb, jb):
    assert tb.keys() == jb.keys()
    for k in tb:
        t, j = np.asarray(tb[k]), np.asarray(jb[k])
        if t.dtype == np.int64:  # the JAX package's x64-off int32
            assert j.dtype in (np.int32, np.int64)
            j = j.astype(np.int64)
        assert t.dtype == j.dtype and t.shape == j.shape, k
        assert np.array_equal(t.view(np.uint8), j.view(np.uint8)), k


def _loader(fluid, feeds, place, **kw):
    loader = fluid.io.DataLoader.from_generator(feed_list=feeds, **kw)
    data = _batches()
    loader.set_batch_generator(lambda: iter(data), places=[place])
    return loader


@pytest.mark.parametrize('double_buffer', [True, False])
def test_generator_batches_bitwise_jax(double_buffer):
    _, jfeeds = _feeds(jfluid)
    _, tfeeds = _feeds(tfluid)
    jl = _loader(jfluid, jfeeds, jfluid.CPUPlace(), capacity=4,
                 use_double_buffer=double_buffer)
    tl = _loader(tfluid, tfeeds, tfluid.CPUPlace(), capacity=4,
                 use_double_buffer=double_buffer)
    jb = [_np(b) for b in jl]
    for _ in range(2):  # a second iteration runs the generator again
        tb = list(tl)
        assert len(tb) == len(jb) == 6
        for t, j in zip(tb, jb):
            assert isinstance(t['x'], np.ndarray)  # nothing staged
            _same(t, j)


def test_sample_list_generator_through_data_feeder_bitwise_jax():
    """DataFeeder turns rows into columns, label [N] -> [N, 1]."""
    _, jfeeds = _feeds(jfluid)
    _, tfeeds = _feeds(tfluid)
    rows = _samples()
    out = []
    for fluid, feeds in ((jfluid, jfeeds), (tfluid, tfeeds)):
        loader = fluid.io.DataLoader.from_generator(
            feed_list=feeds, capacity=2, use_double_buffer=False)
        loader.set_sample_list_generator(
            lambda: (rows[i:i + 4] for i in range(0, len(rows), 4)),
            places=fluid.CPUPlace())
        out.append([_np(b) for b in loader])
    assert [b['y'].shape for b in out[1]] == [(4, 1), (4, 1), (3, 1)]
    for t, j in zip(out[1], out[0]):
        _same(t, j)
    fed = tfluid.DataFeeder(tfeeds, tfluid.CPUPlace()).feed(rows[:2])
    jfed = jfluid.DataFeeder(jfeeds, jfluid.CPUPlace()).feed(rows[:2])
    _same(fed, jfed)


@pytest.mark.parametrize('drop_last', [True, False])
def test_sample_generator_batches_bitwise_jax(drop_last):
    rows = _samples()
    out = []
    for fluid in (jfluid, tfluid):
        _, feeds = _feeds(fluid)
        loader = fluid.io.DataLoader.from_generator(
            feed_list=feeds, capacity=2, use_double_buffer=False)
        loader.set_sample_generator(lambda: iter(rows), batch_size=4,
                                    drop_last=drop_last,
                                    places=fluid.CPUPlace())
        out.append([_np(b) for b in loader])
    assert len(out[1]) == (2 if drop_last else 3)
    for j, t in zip(*out):
        _same(t, j)


def test_pyreader_decorate_start_next_reset_bitwise_jax():
    got = []
    for fluid in (jfluid, tfluid):
        _, feeds = _feeds(fluid)
        reader = fluid.reader.PyReader(feed_list=feeds, capacity=2,
                                       use_double_buffer=False,
                                       iterable=False)
        data = _batches(3)
        reader.decorate_batch_generator(lambda: iter(data),
                                        places=fluid.CPUPlace())
        with pytest.raises(RuntimeError, match='start'):
            reader.next()
        seen = []
        for _ in range(2):  # an epoch, a reset, another epoch
            reader.start()
            while True:
                try:
                    seen.append(_np(reader.next()))
                except StopIteration:
                    break
        assert reader.feed_vars == feeds
        got.append(seen)
    assert len(got[1]) == 6
    for j, t in zip(*got):
        _same(t, j)


def test_layers_py_reader_bitwise_jax():
    got = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            reader = fluid.layers.py_reader(
                capacity=2, shapes=[(-1, 4), (-1, 1)],
                dtypes=['float32', 'int64'], name='r')
            reader = fluid.layers.double_buffer(reader)
            xs = fluid.layers.read_file(reader)
        names = [v.name for v in xs]
        assert names == ['_py_reader_0_r', '_py_reader_1_r']
        assert main.global_block().var(names[0]).shape == (-1, 4)
        data = [(b['x'], b['y']) for b in _batches(2)]
        reader.decorate_batch_generator(lambda: iter(data),
                                        places=fluid.CPUPlace())
        reader._use_double_buffer = False
        reader.start()
        got.append([_np(reader.next()) for _ in range(2)])
    for j, t in zip(*got):
        _same(t, j)


def test_capacity_bounds_producer_runahead():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield {'x': np.full((1,), i, 'float32')}

    it = _AsyncBatchIterator(gen, capacity=3, device=None)
    assert float(next(it)['x'][0]) == 0.0
    time.sleep(0.3)  # the producer runs until the queue is full
    # capacity 3 + staging window 2 + the one in hand + the one consumed
    assert len(produced) <= 8, produced
    it.close()


def test_exhaustion_is_sticky():
    it = _AsyncBatchIterator(lambda: iter([{'x': np.zeros(1)}]),
                             capacity=2, device=None)
    assert next(it) is not None
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(it)


def test_producer_exception_reraises_at_the_consumer():
    def gen():
        yield {'x': np.zeros(1, 'float32')}
        yield {'x': np.ones(1, 'float32')}
        raise RuntimeError('boom in the reader thread')

    it = _AsyncBatchIterator(gen, capacity=2, device=None)
    assert [float(next(it)['x'][0]) for _ in range(2)] == [0.0, 1.0]
    with pytest.raises(RuntimeError, match='boom in the reader'):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_early_break_stops_the_producer():
    stopped = threading.Event()

    def gen():
        try:
            for i in range(10 ** 6):
                yield {'x': np.full((1,), i, 'float32')}
        finally:
            stopped.set()

    it = _AsyncBatchIterator(gen, capacity=2, device=None)
    for k, _ in enumerate(it):
        if k == 3:
            break
    it.close()
    it._thread.join(5.0)
    assert not it._thread.is_alive() and stopped.is_set()


def test_a_new_iteration_closes_the_abandoned_one():
    _, feeds = _feeds(tfluid)
    loader = tfluid.io.DataLoader.from_generator(
        feed_list=feeds, capacity=2, use_double_buffer=False)
    loader.set_batch_generator(
        lambda: ({'x': np.full((1,), i, 'float32')} for i in range(100)))
    it1 = iter(loader)
    next(it1)
    it2 = iter(loader)
    assert it1._stop.is_set()
    assert float(next(it2)['x'][0]) == 0.0
    loader._live_iter.close()


def test_bucketed_loader_shapes_and_masks_bitwise_jax():
    rng = np.random.RandomState(3)
    samples = [(rng.randint(1, 50, rng.randint(1, 14)).astype('int64'),
                np.float32(i)) for i in range(19)]
    got = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            w = fluid.layers.data('w', shape=[-1], dtype='int64',
                                  lod_level=1)
            s = fluid.layers.data('s', shape=[1], dtype='float32')
        loader = fluid.io.DataLoader.from_generator(
            feed_list=[w, s], capacity=4, use_double_buffer=False,
            bucket_boundaries=[4, 8, 16], batch_size=3)
        loader.set_sample_generator(lambda: iter(samples))
        got.append([_np(b) for b in loader])
    assert len(got[1]) == len(got[0]) >= 7
    for j, t in zip(*got):
        _same(t, j)
        assert t['w'].shape[1] in (4, 8, 16)
        assert np.array_equal(t['w@MASK'] != 0, t['w'] != 0)
    with pytest.raises(ValueError, match='ragged'):
        tfluid.io.DataLoader.from_generator(
            feed_list=_feeds(tfluid)[1], bucket_boundaries=[4],
            batch_size=2)


def _reader(n=10):
    def r():
        return iter(range(n))
    return r


_DECORATED = {
    'shuffle': lambda m: m.shuffle(_reader(23), 7),
    'batch': lambda m: m.batch(_reader(), 3),
    'buffered': lambda m: m.buffered(_reader(), 2),
    'compose': lambda m: m.compose(_reader(), m.map_readers(
        lambda a: (a, -a), _reader())),
    'chain': lambda m: m.chain(_reader(3), _reader(4)),
    'map_readers': lambda m: m.map_readers(lambda a, b: a * b, _reader(),
                                           _reader()),
    'xmap_readers': lambda m: m.xmap_readers(lambda a: a * 10, _reader(),
                                             3, 4, order=True),
    'cache_firstn': lambda m: m.firstn(m.cache(_reader()), 4),
}


@pytest.mark.parametrize('name', sorted(_DECORATED))
def test_reader_decorators_match_jax(name):
    out = []
    for mod in (jreader, treader):
        random.seed(11)
        r = _DECORATED[name](mod)
        out.append([list(r()), list(r())])
    if name == 'xmap_readers':  # the JAX package keeps no order here
        assert [sorted(x) for x in out[0]] == out[1]
    else:
        assert out[1] == out[0]
    assert tpaddle.batch is treader.batch


def test_thread_decorators_carry_the_producers_error():
    def bad():
        yield 1
        raise ValueError('bad sample')
    with pytest.raises(ValueError, match='bad sample'):
        list(treader.buffered(bad, 2)())
    with pytest.raises(ValueError, match='bad sample'):
        list(treader.xmap_readers(lambda a: a, bad, 2, 2)())
    # multiprocess_reader's worker, in this process (a fork of a
    # process running JAX's threads may deadlock): samples, then its end
    # or its error marker
    import queue
    q = queue.Queue()
    treader._mp_worker(_reader(3), q)
    treader._mp_worker(bad, q)
    got = [q.get_nowait() for _ in range(q.qsize())]
    assert [k for k, _ in got] == ['item'] * 3 + ['end', 'item', 'error']
    assert 'bad sample' in str(got[-1][1])

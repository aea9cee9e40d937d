"""Reader decorators. Reference: python/paddle/reader/decorator.py
(shuffle, batch, buffered, xmap_readers, compose, chain); JAX:
paddle_tpu/reader/__init__.py.

The thread- and process-backed decorators carry the producer's
exception to the consumer (an error marker on the queue) and wait on
their queues with a timeout, looking again while a producer lives, so a
producer that died never leaves the consumer waiting.
"""

import itertools
import queue as _queue
import random
import threading

_WAIT_S = 0.05


def _drain(q, producers_alive, finished):
    """Items of `q` until `finished` end markers arrived: each ('item',
    x) is yielded, ('end', None) counts one producer done and ('error',
    e) raises e.  A queue that stays empty after every producer has died
    ends the drain."""
    done = 0
    while done < finished:
        try:
            kind, payload = q.get(timeout=_WAIT_S)
        except _queue.Empty:
            if not producers_alive() and q.empty():
                return
            continue
        if kind == 'item':
            yield payload
        elif kind == 'end':
            done += 1
        else:
            raise payload


def shuffle(reader, buf_size):
    def impl():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        random.shuffle(buf)
        for b in buf:
            yield b
    return impl


def batch(reader, batch_size, drop_last=False):
    def impl():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return impl


def buffered(reader, size):
    """Background-thread prefetch (reference decorator.py buffered)."""
    def impl():
        q = _queue.Queue(maxsize=size)

        def worker():
            try:
                for item in reader():
                    q.put(('item', item))
                q.put(('end', None))
            except BaseException as e:  # noqa: B036 — crosses threads
                q.put(('error', e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        for item in _drain(q, t.is_alive, 1):
            yield item
    return impl


def compose(*readers):
    def impl():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)
    return impl


def chain(*readers):
    def impl():
        return itertools.chain(*[r() for r in readers])
    return impl


def map_readers(func, *readers):
    def impl():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return impl


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Thread-pool mapped reader (reference xmap_readers); with `order`
    the mapped samples keep the reader's order."""
    def impl():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        stop = object()

        def feed():
            try:
                for i, s in enumerate(reader()):
                    in_q.put((i, s))
            except BaseException as e:  # noqa: B036 — crosses threads
                out_q.put(('error', e))
            for _ in range(process_num):
                in_q.put(stop)

        def work():
            while True:
                s = in_q.get()
                if s is stop:
                    out_q.put(('end', None))
                    return
                try:
                    out_q.put(('item', (s[0], mapper(s[1]))))
                except BaseException as e:  # noqa: B036
                    out_q.put(('error', e))

        threads = [threading.Thread(target=feed, daemon=True)] + [
            threading.Thread(target=work, daemon=True)
            for _ in range(process_num)]
        for t in threads:
            t.start()
        items = _drain(out_q, lambda: any(t.is_alive() for t in threads),
                       process_num)
        if not order:
            for _, x in items:
                yield x
            return
        pending, nxt = {}, 0
        for i, x in items:
            pending[i] = x
            while nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
    return impl


def cache(reader):
    data = []

    def impl():
        if not data:
            data.extend(reader())
        return iter(data)
    return impl


def firstn(reader, n):
    def impl():
        return itertools.islice(reader(), n)
    return impl


def _mp_worker(reader, q):
    """Module-level worker (picklable under spawn/forkserver)."""
    try:
        for sample in reader():
            if sample is None:
                raise ValueError(
                    'multiprocess_reader: sample cannot be None')
            q.put(('item', sample))
        q.put(('end', None))
    except Exception as e:  # error marker, never hang the consumer
        q.put(('error', RuntimeError(
            'multiprocess_reader worker failed: %s: %s'
            % (type(e).__name__, e))))


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in multiple readers through OS processes (reference
    python/paddle/reader/decorator.py multiprocess_reader).  Both
    use_pipe settings use a multiprocessing.Queue transport."""
    import multiprocessing

    def impl():
        q = multiprocessing.Queue(queue_size)
        procs = [multiprocessing.Process(target=_mp_worker, args=(r, q))
                 for r in readers]
        for p in procs:
            p.daemon = True
            p.start()
        try:
            for item in _drain(q, lambda: any(p.is_alive() for p in procs),
                               len(readers)):
                yield item
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    return impl

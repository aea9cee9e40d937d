"""The compile plane's in-memory half: content fingerprints, the
``LRUCache`` of a Program's run plans, and the process-wide view of
the captured CUDA graphs.

Reference: the JAX package's fluid/compile_cache.py, whose executables
are XLA programs shared by content; here the executable of a program
and feed signature is a ``torch.cuda.CUDAGraph`` captured by the
executor (fluid/cuda_graph.py), and a Program's run plans (fluid/
executor.py ``_Plan``) live in its ``_exec_cache``, an ``LRUCache``
capped by ``FLAGS_plan_cache_capacity`` (0: unbounded).

- ``fingerprint(ops, specs, flag_items)``: a sha256 over everything
  that decides what an executable runs: the op descs (type, inputs,
  outputs, attrs, recursing into control-flow sub-blocks), the
  arguments' shapes and dtypes (``arg_specs``), the flags read at
  Python time, and ``_env_key()``: torch's and CUDA's versions, the
  device, and the source hash of every kernel library.  The op walk
  and its type tags are the JAX package's, so a Program moved between
  the packages with ``to_dict``/``from_dict`` hashes to the same op
  digest.
- ``CompilePlane``: the live captured graphs (held weakly) and the
  plan cache's and the graphs' counters; ``plane()`` is the process's.

Not ported, because nothing here has a counterpart:

- the store of executables shared by content (JAX ``lookup``,
  ``store``, ``obtain`` and their memory LRU): a CUDA graph reads one
  scope's tensors by address, so two programs of one content in two
  scopes (two predictors of one model) can never share one.  A plan
  keeps its graphs per scope and per feed signature instead
  (fluid/cuda_graph.py), and they go with the scope and the plan;
- the on-disk store of serialized executables and the wiring of JAX's
  persistent cache (JAX ``:309-450``): a CUDA graph holds device
  pointers and cannot be serialized, and the kernels' own shared
  libraries already sit on disk under their source hash
  (ops/kernels/common.py ``_lib_path``);
- the background compile pool (JAX ``:363``, ``:507``): a capture runs
  on the calling thread's capture stream, and the kernels build in
  parallel already (``common.build``).
"""

import hashlib
import threading
import weakref

from . import monitor

# bump when the fingerprint recipe changes
FORMAT_VERSION = 1


def count(name, n=1):
    """Count the plan cache's and the graphs' events in fluid.monitor,
    under the JAX package's names where it has them
    ('executor/plan_cache_hit'), so one ``monitor.snapshot()`` carries
    them."""
    monitor.add(name, n)


def counter_value(name):
    return int(monitor.counter_value(name))


class LRUCache(object):
    """Dict-shaped LRU for a Program's plan cache.  ``cap <= 0`` means
    unbounded; ``cap`` may be a callable, read at
    each insertion, so a capacity flag set later reaches caches built
    before.  Each eviction counts ``evict_stat``."""

    __slots__ = ('_d', 'cap', 'evict_stat')

    def __init__(self, cap=0, evict_stat=None):
        self._d = {}
        self.cap = cap if callable(cap) else int(cap or 0)
        self.evict_stat = evict_stat

    def _capacity(self):
        c = self.cap
        return int(c() or 0) if callable(c) else c

    def get(self, key, default=None):
        d = self._d
        try:
            v = d.pop(key)
        except KeyError:
            return default
        d[key] = v  # most recently used
        return v

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __setitem__(self, key, value):
        d = self._d
        d.pop(key, None)
        d[key] = value
        cap = self._capacity()
        if cap > 0:
            while len(d) > cap:
                d.pop(next(iter(d)))
                if self.evict_stat:
                    count(self.evict_stat)

    def __contains__(self, key):
        return key in self._d

    def __iter__(self):
        return iter(list(self._d))

    def __len__(self):
        return len(self._d)

    def keys(self):
        return list(self._d)

    def values(self):
        return list(self._d.values())

    def items(self):
        return list(self._d.items())

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def clear(self):
        self._d.clear()


_MISSING = object()

# ---------------------------------------------------------------- hashing

# attrs that never change what runs: creation-site stacks (and the JAX
# package's cached host-side bucket-count jits)
_VOLATILE_ATTRS = ('__op_callstack__', '__count_fn__')


def _hash_obj(h, v):
    """Feed one python value into the hash with type tags, so the string
    '1' and the int 1 never collide (JAX: compile_cache.py:145)."""
    import numpy as np
    if v is None:
        h.update(b'N')
    elif isinstance(v, bool):
        h.update(b'B1' if v else b'B0')
    elif isinstance(v, (int, np.integer)):
        h.update(b'I' + str(int(v)).encode())
    elif isinstance(v, (float, np.floating)):
        h.update(b'F' + repr(float(v)).encode())
    elif isinstance(v, str):
        h.update(b'S' + v.encode('utf-8', 'replace'))
    elif isinstance(v, bytes):
        h.update(b'Y' + v)
    elif isinstance(v, np.ndarray):
        h.update(b'A' + str(v.dtype).encode() + str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    elif isinstance(v, (list, tuple)):
        h.update(b'L%d(' % len(v))
        for x in v:
            _hash_obj(h, x)
        h.update(b')')
    elif isinstance(v, dict):
        h.update(b'D%d(' % len(v))
        for k in sorted(v, key=str):
            _hash_obj(h, str(k))
            _hash_obj(h, v[k])
        h.update(b')')
    else:
        # rare attr kinds (dtypes, enums): their repr
        h.update(b'R' + repr(v).encode('utf-8', 'replace'))


def _hash_ops(h, ops, seen_blocks):
    """The canonical op-desc walk, recursing into control-flow
    sub-blocks (JAX: compile_cache.py:182)."""
    for op in ops:
        h.update(b'OP' + op.type.encode())
        for label, io in ((b'in', op.inputs), (b'out', op.outputs)):
            h.update(label)
            for slot in sorted(io):
                _hash_obj(h, slot)
                _hash_obj(h, io[slot])
        for k in sorted(op.attrs):
            if k in _VOLATILE_ATTRS:
                continue
            _hash_obj(h, k)
            _hash_obj(h, op.attrs[k])
        sub = op.attrs.get('sub_block')
        if isinstance(sub, int) and sub not in seen_blocks:
            seen_blocks.add(sub)
            h.update(b'SUB%d(' % sub)
            _hash_ops(h, op.block.program.blocks[sub].ops, seen_blocks)
            h.update(b')')


_env_key_cache = None


def _env_key():
    """What invalidates a captured graph besides the program: torch's
    and CUDA's versions, the device's name and compute capability, and
    the build hash of every kernel library (the source, the shared
    headers and the nvcc flags: ops/kernels/common.py ``_lib_path``)."""
    global _env_key_cache
    if _env_key_cache is None:
        import os
        import torch
        from ..ops.kernels import common
        if torch.cuda.is_available():
            dev = (torch.cuda.get_device_name(0),
                   tuple(torch.cuda.get_device_capability(0)))
        else:
            dev = ('cpu', ())
        libs = tuple(sorted(
            os.path.basename(common._lib_path(s)[1]) for s in
            {k['source'] for k in common.KERNELS.values()}))
        _env_key_cache = (FORMAT_VERSION, torch.__version__,
                          str(torch.version.cuda), dev, libs)
    return _env_key_cache


def arg_specs(*arg_dicts):
    """Canonical (name, shape, dtype) tuples over argument dicts, each
    sorted by name, so dicts built in another order give the same key.
    numpy arrays, torch tensors and LoDTensors of one shape and dtype
    give one spec (the port keeps 64-bit types)."""
    from . import core
    out = []
    for d in arg_dicts:
        row = []
        for n, v in d.items():
            v = core.as_array(v)
            if not hasattr(v, 'dtype'):
                import numpy as np
                v = np.asarray(v)
            row.append((n, tuple(int(s) for s in v.shape),
                        _dtype_name(v.dtype)))
        out.append(tuple(sorted(row)))
    return tuple(out)


_dtype_memo = {}


def _dtype_name(dt):
    try:
        return _dtype_memo[dt]
    except (KeyError, TypeError):
        pass
    from . import core
    name = core.dtype_name(dt)
    try:
        _dtype_memo[dt] = name
    except TypeError:
        pass
    return name


def fingerprint(ops, specs, flag_items, donate=True, purpose='aot'):
    """Hex digest naming one executable (JAX: compile_cache.py:261):
    `specs` the arg_specs() tuple, `flag_items` the values read at
    Python time that change what runs, `purpose` the executable family
    ('graph': a captured CUDA graph)."""
    h = hashlib.sha256()
    _hash_obj(h, _env_key())
    _hash_obj(h, purpose)
    _hash_obj(h, bool(donate))
    _hash_obj(h, tuple(flag_items))
    _hash_obj(h, specs)
    _hash_ops(h, ops, set())
    return h.hexdigest()


# ---------------------------------------------------------------- plane
class CompilePlane(object):
    """The process's view of the compile plane: the live captured
    graphs, which their plans own (held weakly here), and the
    counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._graphs = weakref.WeakSet()
        # set by Executor.warmup (fluid/health.py readiness)
        self._warmed = False

    def register(self, graph):
        with self._lock:
            self._graphs.add(graph)

    def entry_count(self):
        """Captured graphs alive in the process."""
        with self._lock:
            return len(self._graphs)

    def stats(self):
        """One snapshot: live graphs and the plane's counters."""
        out = {'memory_entries': self.entry_count()}
        for k in ('plan_cache_hit', 'plan_cache_miss', 'plan_cache_bypass',
                  'plan_cache_evictions', 'graph_first_runs',
                  'graph_captures', 'graph_replays', 'graph_stale',
                  'graph_refused', 'graph_pool_bytes'):
            out[k] = counter_value('executor/' + k)
        return out


_plane = None
_plane_lock = threading.Lock()


def plane():
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = CompilePlane()
    return _plane


def reset_plane():
    """Start a new process-wide plane (tests): it sees only the graphs
    captured from then on."""
    global _plane
    with _plane_lock:
        old, _plane = _plane, None
    return old

"""CUDA graphs of a program's run: the port's counterpart of the JAX
package's compiled segment executables.

``Executor.run`` sends a program whose plan may be captured (no op
draws from a host generator, it is not collective,
``FLAGS_check_nan_inf`` is off: serving, ``for_test`` clones and
training steps, the whole-program grad's and the per-op grad path's
alike, batch norms' running statistics included) on a CUDA place here,
with the program cache on.  The plan keeps its graphs per scope,
since a graph reads that scope's tensors by address and no other scope
can replay it, and per signature: the feeds' names, shapes and dtypes and the
switches read at Python time (``FLAGS_torch_kernels_plain``, the TF32
switches), so the plain path never replays a kernel graph.  The graphs
of a scope go with the scope, and those of a plan with the plan (a
rewrite of the program drops both).  Per signature:

1. the first run is eager, on the executor's capture stream: it builds
   the kernels, moves the scope's host values to the device and gives
   cuBLAS its workspace on that stream, as PyTorch's capture rules ask;
2. the second run moves any value the plan reads from the scope that
   is still on the host (a ``set_var`` of an array since) to the
   device, captures the graph (``torch.cuda.graph`` on the capture
   stream, from the memory pool all graphs of the executor share) and
   replays it;
3. every later run replays it.

A capture that fails (an op that synchronizes with the host) leaves
the reason in the graph's place: the signature runs eagerly on that
scope from then on (the failed capture's run among them, as the same
step), and ``executor/graph_refused`` counts it.

A training step is captured as it runs eagerly.  It writes every
persistable variable into the tensor the scope holds
(``Executor._write_state``), so its graph reads and updates the same
state at each replay, and it reads the step from a static input of the
graph (``Executor._step_mix``), from which the attention-dropout
seed and the dropout op's mask are computed on the device: a replay
draws the masks of its own step, and ``Executor._step`` stays the one
count (setting it before a run is honoured by the replay).  The
optimizer kernels' pointer tables that a capture uploads
(``common.upload``) go into buffers the graph keeps, allocated on the
stream it replays on rather than from its memory pool (whose blocks
the graph's earlier kernels overwrite at every replay), and are copied
there once, after the capture.

A graph owns static input tensors, which a run fills from the feeds
and the step through pinned host buffers (one host-to-device copy a
feed, 8 bytes for the step), and static outputs, which a run copies
out: into pinned host buffers for ``return_numpy=True``, into new
device tensors otherwise, so no caller holds memory the next replay
overwrites.  It keeps (weakly) the scope
tensors it read at capture; a replay first checks each is still the
object the scope holds, and after a ``set_var`` or a load the
signature runs eagerly once more and is captured again.  Kernel
launches made during the capture are recorded in the graph's manifest
(``common.recording_launches``); each replay counts them as replayed
launches (``common.add_replays``), apart from the launches the
wrappers count.

A replayed step records its phases around the replay: ``feed_h2d``
(the static inputs filled), ``dispatch`` (``graph.replay()``, after
the ``executor.dispatch`` fault-injection site) and ``fetch_d2h``; a
capture records no span and no step (the executor's ``_run_plan``
records nothing while ``exe._reads`` is set), so a captured-and-
replayed step counts once, as the replay.

``warm`` (``Executor.warmup``) of a training step runs its first step
from zero feeds and puts the state it wrote back as it was, in place,
before it captures; the capture itself runs nothing.
"""

import time
import weakref

import numpy as np
import torch

from . import compile_cache
from . import core
from . import faultinject as _finject
from . import trace as _trace
from .flags import get_flag
from ..ops.kernels import common


# a signature whose first run was eager: its next run captures
_SEEN = object()
# the step's name among a graph's static inputs
_STEP = '@STEP@'


def _signature(feed):
    return (compile_cache.arg_specs(feed),
            bool(get_flag('FLAGS_torch_kernels_plain', False)),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _graphs(plan, scope):
    """{signature: CapturedStep, _SEEN or the reason a capture failed}
    of `plan` on `scope`."""
    graphs = plan.graphs.get(scope)
    if graphs is None:
        graphs = plan.graphs[scope] = {}
    return graphs


def _scope_reads(plan):
    """The names the plan's ops read before any op writes them."""
    if plan.scope_reads is None:
        from .executor import _op_reads
        written, reads = set(), {}
        for op in plan.ops:
            reads.update((n, None) for n in _op_reads(op)
                         if n not in written)
            written.update(op.output_arg_names)
        plan.scope_reads = tuple(reads)
    return plan.scope_reads


def _to_device_reads(exe, plan, feed, scope):
    """Move each value the plan reads from the scope that is not on the
    device there, where it lives: the capture must not copy from
    pageable host memory."""
    for n in _scope_reads(plan):
        if n in feed:
            continue
        vars_ = scope._owner_vars(n)
        v = None if vars_ is None else vars_[n]
        if v is not None and not (isinstance(v, torch.Tensor) and
                                  v.device == exe.device):
            vars_[n] = exe._to_device(v)


def _streams(exe):
    if exe._capture_stream is None:
        exe._capture_stream = torch.cuda.Stream(exe.device)
        exe._graph_pool = torch.cuda.graph_pool_handle()
    return exe._capture_stream


def _eager_on_capture_stream(exe, plan, program, feed, fetch_names, scope):
    """A run on the capture stream, ordered after and before the
    current stream's work; its results are recorded on the current
    stream, where the caller uses them."""
    main = torch.cuda.current_stream(exe.device)
    side = _streams(exe)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        exe._step += 1
        results = exe._run_plan(plan, program, feed, fetch_names, scope)
    main.wait_stream(side)
    for r in results:
        if isinstance(r, torch.Tensor) and r.is_cuda:
            r.record_stream(main)
    return results


class CapturedStep(object):
    """One program and feed signature captured in a CUDA graph."""

    __slots__ = ('device', 'graph', 'inputs', 'outputs', 'reads', 'token',
                 'manifest', 'uploads', 'pool_bytes', 'host_out', 'h2d',
                 '__weakref__')

    def valid(self, scope):
        """True while every scope tensor the capture read is still the
        object the scope holds.  The graph holds those tensors weakly:
        it never keeps a predictor's weights alive."""
        if scope._chain_token() != self.token:
            for i, (_, n, t) in enumerate(self.reads):
                owner = scope.find_scope(n)
                if owner is None or owner._vars.get(n) is not t():
                    return False
                self.reads[i] = (weakref.ref(owner), n, t)
            self.token = scope._chain_token()
            return True
        for owner, n, t in self.reads:
            owner = owner()
            if owner is None or owner._vars.get(n) is not t():
                return False
        return True

    def feed(self, feed, step):
        """Copy the feeds and the step into the static inputs: host
        values through the pinned buffers, device tensors directly (the
        replayed step's 'feed_h2d' phase)."""
        t0 = time.perf_counter()
        self._feed(feed, step)
        _trace.record('feed_h2d', t0, time.perf_counter())

    def _feed(self, feed, step):
        if self.h2d is not None:
            self.h2d.synchronize()  # the pinned buffers are free again
        for name, (static, pinned, view) in self.inputs.items():
            v = core.as_array(step if name == _STEP else feed[name])
            if isinstance(v, torch.Tensor):
                if v.is_cuda:
                    static.copy_(v, non_blocking=True)
                    continue
                pinned.copy_(v)
            else:
                np.copyto(view, np.asarray(v), casting='no')
            static.copy_(pinned, non_blocking=True)
        self.h2d = torch.cuda.Event()
        self.h2d.record(torch.cuda.current_stream(self.device))

    def replay(self, return_numpy, step=None):
        """One replay of the graph: the replayed step's 'dispatch' phase
        (the executor.dispatch fault site before it) and its fetches
        ('fetch_d2h' where they come back to the host)."""
        if _finject.armed():
            _finject.check('executor.dispatch', step=step)
        t0 = time.perf_counter()
        self.graph.replay()
        common.add_replays(self.manifest)
        compile_cache.count('executor/graph_replays')
        t1 = time.perf_counter()
        _trace.record('dispatch', t0, t1)
        if return_numpy is True:
            for host, out in zip(self.host_out, self.outputs):
                host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = [host.numpy().copy() for host in self.host_out]
            _trace.record('fetch_d2h', t1, time.perf_counter())
            return out
        with torch.inference_mode():
            outs = [o.clone() for o in self.outputs]
        if return_numpy == 'async':
            from .executor import FetchHandle
            return [FetchHandle(o) for o in outs]
        return outs


def _capture(exe, plan, program, feed, fetch_names, scope):
    """Capture one run of `plan` on the feeds' signature, as the next
    executor step."""
    dev = exe.device
    side = _streams(exe)
    _to_device_reads(exe, plan, feed, scope)
    cap = CapturedStep()
    cap.device = dev
    cap.inputs = {}
    exe._step += 1
    for name, v in list(feed.items()) + [(_STEP, np.int64(exe._step))]:
        v = core.as_array(v)
        if not hasattr(v, 'dtype'):
            v = np.asarray(v)
        dtype = core.convert_dtype(v.dtype)
        shape = tuple(v.shape)
        static = torch.empty(shape, dtype=dtype, device=dev)
        pinned = torch.empty(shape, dtype=dtype, pin_memory=True)
        view = None if dtype == torch.bfloat16 else pinned.numpy()
        cap.inputs[name] = (static, pinned, view)
    cap.h2d = None
    cap._feed(feed, exe._step)
    main = torch.cuda.current_stream(dev)
    main.synchronize()
    cap.graph = torch.cuda.CUDAGraph()
    exe._reads = {}
    try:
        # the kernels' host tables go into buffers on the stream the
        # graph replays on, which the graph's pool never reuses
        with common.recording_launches(main) as rec:
            with torch.cuda.graph(cap.graph, pool=exe._graph_pool,
                                  stream=side):
                before = torch.cuda.memory_reserved(dev)
                env = {n: x for n, (x, _, _) in cap.inputs.items()
                       if n != _STEP}
                outs = exe._run_plan(plan, program, feed, fetch_names,
                                     scope, env=env,
                                     step_t=cap.inputs[_STEP][0])
        reads = exe._reads
    except BaseException:
        # a failed capture_end leaves torch.cuda.graph's stream context
        # open: the caller's stream is current again
        torch.cuda.set_stream(main)
        raise
    finally:
        exe._reads = None
    cap.pool_bytes = torch.cuda.memory_reserved(dev) - before
    cap.manifest = dict(rec.launches)
    # the tables the capture uploaded, once, before the first replay
    cap.uploads = rec.uploads
    for buf, host in cap.uploads:
        buf.copy_(torch.from_numpy(host))
    # a training step's fetched forward value (an AMP program's unscaled
    # loss) is part of autograd's graph: the static output keeps the
    # value alone
    cap.outputs = [o.detach() if isinstance(o, torch.Tensor) else o
                   for o in outs]
    outs = cap.outputs
    for n, o in zip(fetch_names, outs):
        if not (isinstance(o, torch.Tensor) and o.is_cuda):
            raise TypeError('fetch %r is not a CUDA tensor in the captured '
                            'graph' % n)
    cap.host_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in outs]
    cap.reads = [(weakref.ref(scope.find_scope(n)), n, weakref.ref(t))
                 for n, (_, t) in reads.items()]
    cap.token = scope._chain_token()
    compile_cache.plane().register(cap)
    compile_cache.count('executor/graph_captures')
    compile_cache.count('executor/graph_pool_bytes', cap.pool_bytes)
    return cap


def _try_capture(exe, plan, program, feed, fetch_names, scope, graphs,
                 sig):
    """The signature's graph, or the reason its capture failed, kept in
    `graphs` either way.  A failed capture leaves ``exe._step`` as it
    found it: the run goes eager as that step."""
    step = exe._step
    try:
        cap = _capture(exe, plan, program, feed, fetch_names, scope)
    except Exception as e:  # kept as the reason: the run goes eager
        exe._step = step
        cap = 'the capture failed: %s: %s' % (type(e).__name__, e)
        compile_cache.count('executor/graph_refused')
    graphs[sig] = cap
    return cap


def run(exe, plan, program, feed, fetch_names, scope, return_numpy):
    """One run of a capturable plan through its graph for this feed
    signature: the signature's first run (eager, on the capture
    stream), its capture with a replay, or a replay.  None where the
    executor runs it eagerly itself: a program that stays eager
    (``Executor._no_graph``) and a signature whose capture failed."""
    if exe._no_graph(program) is not None:
        return None
    with torch.cuda.device(exe.device):
        return _run(exe, plan, program, feed, fetch_names, scope,
                    return_numpy)


def _run(exe, plan, program, feed, fetch_names, scope, return_numpy):
    graphs = _graphs(plan, scope)
    sig = _signature(feed)
    entry = graphs.get(sig)
    if isinstance(entry, CapturedStep):
        if entry.valid(scope):
            exe._step += 1
            entry.feed(feed, exe._step)
            return entry.replay(return_numpy, exe._step)
        compile_cache.count('executor/graph_stale')
        entry = None
    if entry is None:
        compile_cache.count('executor/graph_first_runs')
        results = _eager_on_capture_stream(exe, plan, program, feed,
                                           fetch_names, scope)
        graphs[sig] = _SEEN
        return exe._return(results, return_numpy)
    if entry is _SEEN:
        entry = _try_capture(exe, plan, program, feed, fetch_names, scope,
                             graphs, sig)
    if isinstance(entry, str):
        return None
    return entry.replay(return_numpy, exe._step)


def _written_state(plan, scope):
    """{name: tensor} of the persistable variables `plan` writes that
    the scope holds as tensors."""
    from .executor import _is_persistable
    block = plan.ops[0].block
    out = {}
    for op in plan.ops:
        for n in op.output_arg_names:
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor) and _is_persistable(block, n):
                out[n] = v
    return out


def warm(exe, plan, program, feed, fetch_names, scope):
    """Executor.warmup of one signature: its first run and its capture,
    from the device tensors of `feed`; a training step's first run
    leaves the state as it found it.  None, or the reason the capture
    failed."""
    with torch.cuda.device(exe.device):
        graphs = _graphs(plan, scope)
        sig = _signature(feed)
        entry = graphs.get(sig)
        if isinstance(entry, CapturedStep) and entry.valid(scope):
            return None
        if isinstance(entry, str):
            return entry
        state = _written_state(plan, scope)
        kept = {n: v.clone() for n, v in state.items()}
        _eager_on_capture_stream(exe, plan, program, feed, fetch_names,
                                 scope)
        for n, v in state.items():
            v.copy_(kept[n])
            if scope.find_var(n) is not v:
                scope.set_var(n, v)
        entry = _try_capture(exe, plan, program, feed, fetch_names, scope,
                             graphs, sig)
        return entry if isinstance(entry, str) else None

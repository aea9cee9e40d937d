"""CUDA graphs of a program's run: the port's counterpart of the JAX
package's compiled segment executables.

``Executor.run`` sends every plan on a CUDA place here, with the program
cache on, but a collective program's and one whose every device unit is
refused: a unit that draws from a host generator (a startup program's
initializer: startup programs stay eager by design, they run once) or
runs a host op inside a loop body.  Serving, ``for_test`` clones and
training steps, the whole-program grad's and the per-op grad path's
alike, under ``FLAGS_check_nan_inf`` too, are replayed.  The plan keeps
its graphs per scope,
since a graph reads that scope's tensors by address and no other scope
can replay it, and per signature: the feeds' names, shapes and dtypes and the
switches read at Python time (``FLAGS_torch_kernels_plain``, the TF32
switches), so the plain path never replays a kernel graph.  The graphs
of a scope go with the scope, and those of a plan with the plan (a
rewrite of the program drops both).  Per signature:

1. the first run is eager, on the executor's capture stream: it builds
   the kernels, moves the scope's host values to the device and gives
   cuBLAS its workspace on that stream, as PyTorch's capture rules ask,
   and captures each conditional_block branch it does not take into a
   graph it throws away (``warm_branch``: relaxed mode, nothing runs),
   so nothing is first built in a capture;
2. the second run moves any value the plan reads from the scope that
   is still on the host (a ``set_var`` of an array since) to the
   device, captures the graph (``torch.cuda.graph`` on the capture
   stream, from the memory pool all graphs of the executor share) and
   replays it;
3. every later run replays it.

A plan that host ops split (``_Plan.units``) runs as a pipeline
(``Pipeline``) on the capture stream: each device unit follows the same
three runs with a graph of its own (``CapturedUnit``, keyed by the
signature and the unit's index), whose static inputs are the env values
it reads (an earlier unit's graph outputs are read in place), and the
host ops run between the replays; a host op that replaces a scope
tensor the next unit read makes that unit's graph stale (``valid``),
while one that writes in place (a load of the same shape and dtype)
does not.  The fetches of a pipeline come back as copies.

Control flow stays on the device in a capture: a forward-only while is
a CUDA graph WHILE node, a conditional_block an IF node
(``while_node``, ``if_node``; ops/kernels/graph_cond.py sets each
node's handle from the condition tensor), their bodies captured on body
streams into the nodes' body graphs, their loop state in fixed buffers.
An auto-bucketed while's trips are counted before the step by a graph
of their own (``count_buckets``) and the step replays the graph of its
bucket.  A node's launches are counted at each replay times its runs,
read from its counter after the replay with the fetches.

A capture that fails (an op that synchronizes with the host) leaves
the reason in the graph's place: the signature runs eagerly on that
scope from then on (the failed capture's run among them, as the same
step), and ``executor/graph_refused`` counts it.  A conditional node
that cannot be built, added or launched (graph_cond's
``ConditionalNodeError``: CUDA before 12.3, a kernel that does not
build) raises instead: on the card a while or a conditional_block never
falls back to the host loop.  A conditional_block that carries
gradients keeps its unit eager (``Executor._host_control``).

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

Under ``FLAGS_check_nan_inf`` a graph checks the step's values in one
finite_check launch at its end and keeps device copies of what the step
read (the NaN provenance's inputs); a replay copies the verdicts to the
host with the fetches and raises as the eager step does.

A replayed step records its phases around the replay: ``feed_h2d``
(the static inputs filled), ``dispatch`` (``graph.replay()``, after
the ``executor.dispatch`` fault-injection site) and ``fetch_d2h``; a
capture records no span and no step (the executor's ``_run_plan``
records nothing while ``exe._reads`` is set), so a captured-and-
replayed step counts once, as the replay.

``warm`` (``Executor.warmup``) of a training step runs its first step
from zero feeds and puts the state it wrote back as it was, in place,
before it captures; the capture itself runs nothing.  A pipeline and a
plan with an auto-bucketed while are captured at their runs, not
warmed.
"""

import contextlib
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
from ..ops.kernels import graph_cond


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
    stream, where the caller uses them.  Each conditional_block branch
    it does not take is built without running (``warm_branch``), so
    that nothing in a branch is first built inside the capture."""
    main = torch.cuda.current_stream(exe.device)
    side = _streams(exe)
    side.wait_stream(main)
    exe._warm_branches = True
    try:
        with torch.cuda.stream(side):
            exe._step += 1
            results = exe._run_plan(plan, program, feed, fetch_names, scope)
    finally:
        exe._warm_branches = False
    main.wait_stream(side)
    for r in results:
        if isinstance(r, torch.Tensor) and r.is_cuda:
            r.record_stream(main)
    return results


class _Replayed(object):
    """What the captured graphs share (a step's ``CapturedStep``, a
    pipeline unit's ``CapturedUnit``, the bucket count's
    ``CapturedCount``): the capture itself (``_capture_graph``), with
    the scope tensors it read, its launch manifest, its conditional
    nodes' counters and manifests and the kernels' uploaded tables;
    static inputs filled from the feeds (``_feed``); a replay's count
    and the copies the host reads after it."""

    __slots__ = ('device', 'graph', 'inputs', 'h2d', 'reads', 'token',
                 'manifest', 'uploads', 'pool_bytes', 'nodes', 'nan',
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

    def _static_inputs(self, feed, step):
        """Static inputs for the feeds and the step, filled from them."""
        self.inputs = {n: _static_input(n, v, self.device) for n, v in
                       list(feed.items()) + [(_STEP, np.int64(step))]}
        self.h2d = None
        self._feed(feed, step)

    def _feed(self, feed, step):
        """Copy the feeds and the step into the static inputs: host
        values through the pinned buffers, device tensors directly."""
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

    def _capture_graph(self, exe, plan, scope, ops, stream, uploads, run):
        """Capture `run()` on `stream` into ``self.graph``, from the
        memory pool the executor's graphs share, and return what it
        returns.  The conditional nodes of `ops` need CUDA 12.3 and get
        their body streams ready first; the kernels' host tables go into
        buffers allocated on `uploads`, a stream that is not capturing
        (the graph's pool would reuse them), filled once after the
        capture.  A failed capture leaves the caller's stream current
        and raises."""
        dev = self.device = exe.device
        caller = torch.cuda.current_stream(dev)
        depth = control_depth(plan.ops[0].block.program, ops) \
            if ops else 0
        if depth:
            graph_cond.require_conditional_nodes()
            warm_body_streams(exe, depth)
        caller.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        saved, exe._reads = exe._reads, {}
        try:
            with common.recording_launches(uploads) as rec:
                with torch.cuda.graph(self.graph, pool=exe._graph_pool,
                                      stream=stream):
                    before = torch.cuda.memory_reserved(dev)
                    exe._nodes = Nodes(dev) if depth else None
                    out = run()
            reads = exe._reads
        except BaseException:
            # a failed capture_end leaves torch.cuda.graph's stream
            # context open: the caller's stream is current again
            torch.cuda.set_stream(caller)
            exe._nodes = exe._captured_nan = None
            raise
        finally:
            exe._reads = saved
        self.pool_bytes = torch.cuda.memory_reserved(dev) - before
        self.manifest = dict(rec.launches)
        nodes, exe._nodes = exe._nodes, None
        counts = node_counts(nodes)
        self.nodes = None if counts is None else \
            (counts[0], counts[1], list(nodes.manifests))
        self.uploads = rec.uploads
        for buf, host in self.uploads:
            buf.copy_(torch.from_numpy(host))
        self.reads = [(weakref.ref(scope.find_scope(n)), n, weakref.ref(t))
                      for n, (_, t) in reads.items()]
        self.token = scope._chain_token()
        compile_cache.plane().register(self)
        compile_cache.count('executor/graph_captures')
        compile_cache.count('executor/graph_pool_bytes', self.pool_bytes)
        return out

    def _count(self):
        """Count one replay's launches (the caller has synchronized the
        node counters' copy)."""
        common.add_replays(self.manifest)
        if self.nodes is not None:
            count_node_replays(self.nodes[2], self.nodes[1])
        compile_cache.count('executor/graph_replays')

    def _queue_reads(self):
        """Queue the copies the host reads after a replay: the node
        counters (and the verdicts, where the step is checked)."""
        if self.nodes is not None:
            self.nodes[1].copy_(self.nodes[0], non_blocking=True)
        if self.nan is not None:
            self.nan[2].copy_(self.nan[1], non_blocking=True)


class CapturedStep(_Replayed):
    """One program and feed signature captured in a CUDA graph."""

    __slots__ = ('outputs', 'host_out')

    def feed(self, feed, step):
        """Copy the feeds and the step into the static inputs (the
        replayed step's 'feed_h2d' phase)."""
        t0 = time.perf_counter()
        self._feed(feed, step)
        _trace.record('feed_h2d', t0, time.perf_counter())

    def replay(self, exe, return_numpy, step=None):
        """One replay of the graph: the replayed step's 'dispatch' phase
        (the executor.dispatch fault site before it) and its fetches
        ('fetch_d2h' where they come back to the host).  The node
        counters and the verdicts come back in the same copy as the
        fetches; a verdict of 0 raises as the eager step does."""
        if _finject.armed():
            _finject.check('executor.dispatch', step=step)
        t0 = time.perf_counter()
        self.graph.replay()
        t1 = time.perf_counter()
        _trace.record('dispatch', t0, t1)
        host_reads = self.nodes is not None or self.nan is not None
        if return_numpy is True:
            for host, out in zip(self.host_out, self.outputs):
                host.copy_(out, non_blocking=True)
            self._queue_reads()
            torch.cuda.current_stream(self.device).synchronize()
            out = [host.numpy().copy() for host in self.host_out]
            _trace.record('fetch_d2h', t1, time.perf_counter())
        else:
            with torch.inference_mode():
                out = [o.clone() for o in self.outputs]
            if host_reads:
                self._queue_reads()
                torch.cuda.current_stream(self.device).synchronize()
            if return_numpy == 'async':
                from .executor import FetchHandle
                out = [FetchHandle(o) for o in out]
        self._count()
        if self.nan is not None:
            names, _, host, snap, plan, program = self.nan
            exe._raise_bad(names, host.tolist(), plan, snap, program)
        return out


def _static_input(name, v, dev):
    """(static device tensor, pinned host buffer, its numpy view) for a
    graph input shaped as `v`."""
    v = core.as_array(v)
    if not hasattr(v, 'dtype'):
        v = np.asarray(v)
    dtype = core.convert_dtype(v.dtype)
    shape = tuple(v.shape)
    static = torch.empty(shape, dtype=dtype, device=dev)
    pinned = torch.empty(shape, dtype=dtype, pin_memory=True)
    view = None if dtype == torch.bfloat16 else pinned.numpy()
    return static, pinned, view


def _nan_buffers(exe, plan, program):
    """The captured step's (names, verdicts, pinned host copy, snapshot,
    plan, program) under FLAGS_check_nan_inf, else None."""
    captured, exe._captured_nan = exe._captured_nan, None
    if captured is None:
        return None
    names, verdicts, snap = captured
    return (names, verdicts, torch.empty(verdicts.shape, dtype=torch.uint8,
                                         pin_memory=True), snap, plan,
            program)


def _capture(exe, plan, program, feed, fetch_names, scope):
    """Capture one run of `plan` on the feeds' signature, as the next
    executor step."""
    side = _streams(exe)
    main = torch.cuda.current_stream(exe.device)
    _to_device_reads(exe, plan, feed, scope)
    cap = CapturedStep()
    cap.device = exe.device
    exe._step += 1
    cap._static_inputs(feed, exe._step)
    exe._captured_nan = None
    env = {n: x for n, (x, _, _) in cap.inputs.items() if n != _STEP}

    def run():
        outs = exe._run_plan(plan, program, feed, fetch_names, scope,
                             env=env, step_t=cap.inputs[_STEP][0])
        for n, o in zip(fetch_names, outs):
            if not (isinstance(o, torch.Tensor) and o.is_cuda):
                raise TypeError('fetch %r is not a CUDA tensor in the '
                                'captured graph' % n)
        return outs
    outs = cap._capture_graph(exe, plan, scope, plan.ops, side, main, run)
    cap.nan = _nan_buffers(exe, plan, program)
    # a training step's fetched forward value (an AMP program's unscaled
    # loss) is part of autograd's graph: the static output keeps the
    # value alone
    cap.outputs = [o.detach() for o in outs]
    cap.host_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                    for o in cap.outputs]
    return cap


def _refused(e):
    """The reason a failed capture leaves in its graph's place (the
    signature or unit then runs eagerly), or, where a conditional node
    could not be built, added or launched, the error raised again: the
    card has no fallback to the host loop."""
    if isinstance(e, graph_cond.ConditionalNodeError):
        raise e
    compile_cache.count('executor/graph_refused')
    return 'the capture failed: %s: %s' % (type(e).__name__, e)


def _try_capture(exe, plan, program, feed, fetch_names, scope, graphs,
                 sig):
    """The signature's graph, or the reason its capture failed, kept in
    `graphs` either way.  A failed capture leaves ``exe._step`` as it
    found it: the run goes eager as that step."""
    step = exe._step
    try:
        cap = _capture(exe, plan, program, feed, fetch_names, scope)
    except Exception as e:
        exe._step = step
        cap = _refused(e)
    graphs[sig] = cap
    return cap


def run(exe, plan, program, feed, fetch_names, scope, return_numpy):
    """One run of a capturable plan through its graphs for this feed
    signature: the signature's first run (eager, on the capture
    stream), its capture with a replay, or a replay; a plan of several
    units runs as a pipeline, each device unit replayed from a graph of
    its own (``Pipeline``).  None where the executor runs it eagerly
    itself: a program that stays eager (``Executor._no_graph``) and a
    one-unit signature whose capture failed."""
    if exe._no_graph(program) is not None:
        return None
    with torch.cuda.device(exe.device):
        sig = _signature(feed)
        if plan.buckets:
            sig += (count_buckets(exe, plan, program, feed, scope, sig),)
        if len(plan.units) > 1 or plan.units[0].host:
            return _run_pipeline(exe, plan, program, feed, fetch_names,
                                 scope, return_numpy, sig)
        return _run(exe, plan, program, feed, fetch_names, scope,
                    return_numpy, sig)


def _run(exe, plan, program, feed, fetch_names, scope, return_numpy, sig):
    graphs = _graphs(plan, scope)
    entry = graphs.get(sig)
    if isinstance(entry, CapturedStep):
        if entry.valid(scope):
            exe._step += 1
            entry.feed(feed, exe._step)
            return entry.replay(exe, return_numpy, exe._step)
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
    return entry.replay(exe, return_numpy, exe._step)


# ------------------------------------------------------------ pipelines
class CapturedUnit(_Replayed):
    """One device unit of a pipeline captured in a CUDA graph: its
    static inputs (the values it reads from the step's env: feeds,
    earlier units' outputs, host ops' outputs), the step, the env values
    it leaves (``outputs``), the env names it releases and, under
    FLAGS_check_nan_inf, (names, verdicts) of the values it checks,
    which the step reads with its other units' (``verdicts``)."""

    __slots__ = ('step', 'step_host', 'outputs', 'dropped', 'verdicts')

    def replay(self, exe, env):
        """Fill the static inputs from `env` (where an input is not the
        very tensor the capture read) and the step, replay, and leave
        the unit's outputs in `env`."""
        t0 = time.perf_counter()
        if self.h2d is not None:
            self.h2d.synchronize()
        for n, static in self.inputs.items():
            v = env.get(n)
            if v is not static:
                static.copy_(exe._to_device(v), non_blocking=True)
        self.step_host.fill_(exe._step)
        self.step.copy_(self.step_host, non_blocking=True)
        self.h2d = torch.cuda.Event()
        self.h2d.record(torch.cuda.current_stream(self.device))
        t1 = time.perf_counter()
        _trace.record('feed_h2d', t0, t1)
        if _finject.armed():
            _finject.check('executor.dispatch', step=exe._step)
        self.graph.replay()
        _trace.record('dispatch', t1, time.perf_counter())
        if self.nodes is not None:
            self._queue_reads()
            torch.cuda.current_stream(self.device).synchronize()
        self._count()
        if self.verdicts is not None:
            exe._verdicts.append(self.verdicts)
        for n in self.dropped:
            env.pop(n, None)
        env.update(self.outputs)


class Pipeline(object):
    """The graphs of a multi-unit plan's signature on one scope: for each
    device unit None (not run yet), _SEEN (its first run was eager), a
    CapturedUnit or the reason its capture failed; ``outputs``, the ids
    of the captured units' output tensors, which a later unit's capture
    reads in place."""

    __slots__ = ('units', 'outputs', 'stream')

    def __init__(self, n):
        self.units = [None] * n
        self.outputs = set()
        # the caller's stream, on which a capture's upload buffers are
        # allocated: not the capturing stream, whose blocks are the
        # graph's pool
        self.stream = None

    def run(self, exe, plan, k, env, scope, program):
        """Unit k through its graph: True where a replay ran it, False
        where the executor runs it eagerly (its first run, a stale
        graph's, a failed capture's)."""
        entry = self.units[k]
        if isinstance(entry, CapturedUnit):
            if entry.valid(scope):
                entry.replay(exe, env)
                return True
            compile_cache.count('executor/graph_stale')
            entry = None
        if entry is None:
            compile_cache.count('executor/graph_first_runs')
            self.units[k] = _SEEN
            return False
        if entry is _SEEN:
            try:
                entry = _capture_unit(exe, plan, k, env, scope, program,
                                      self.outputs, self.stream)
            except Exception as e:
                entry = _refused(e)
            self.units[k] = entry
            if isinstance(entry, CapturedUnit):
                self.outputs.update(id(v) for v in entry.outputs.values())
                entry.replay(exe, env)
                return True
        return False


def _capture_unit(exe, plan, k, env, scope, program, earlier, stream):
    """Capture pipeline unit k of `plan` as it runs in the current step,
    from `env`; the inputs that are outputs of an earlier unit's graph
    (ids in `earlier`) are read in place.  The kernels' host tables go
    into buffers allocated on `stream`, which is not capturing."""
    dev = exe.device
    unit = plan.units[k]
    for n in unit.reads:
        if n not in env:
            vars_ = scope._owner_vars(n)
            v = None if vars_ is None else vars_[n]
            if v is not None and not (isinstance(v, torch.Tensor) and
                                      v.device == dev):
                vars_[n] = exe._to_device(v)
    cap = CapturedUnit()
    cap.device = dev
    cap.inputs = {}
    for n in unit.reads:
        if n not in env:
            continue
        v = core.as_array(env[n])
        if isinstance(v, torch.Tensor) and v.is_cuda and id(v) in earlier:
            cap.inputs[n] = v
        else:
            cap.inputs[n] = exe._to_device(v).detach().clone()
    cap.step = torch.empty((), dtype=torch.int64, device=dev)
    cap.step_host = torch.empty((), dtype=torch.int64, pin_memory=True)
    cap.h2d = cap.nan = None
    local = dict(env)
    local.update(cap.inputs)
    saved = (exe._ranges, exe._verdicts)
    exe._ranges = False
    checked = None if exe._verdicts is None else []
    exe._verdicts = checked

    def run():
        exe._step_t, exe._step_mixes = cap.step, None
        exe._run_device_unit(plan, unit, local, scope, program, False)
        return exe._verdict_launch(checked) if checked else None
    try:
        cap.verdicts = cap._capture_graph(
            exe, plan, scope, unit.ops, torch.cuda.current_stream(dev),
            stream, run)
    finally:
        exe._ranges, exe._verdicts = saved
        exe._step_t = exe._step_mixes = None
    cap.outputs = {n: v.detach() if isinstance(v, torch.Tensor) else v
                   for n, v in local.items()
                   if n not in cap.inputs and env.get(n) is not v}
    cap.dropped = [n for n in env if n not in local]
    return cap


def _run_pipeline(exe, plan, program, feed, fetch_names, scope,
                  return_numpy, sig):
    """One step of a multi-unit plan on the capture stream: the host
    units run on the host, each device unit eagerly at its signature's
    first run, captured at its second and replayed after.  The fetches
    are copies: a unit's outputs are its graph's, which the next replay
    overwrites."""
    graphs = _graphs(plan, scope)
    entry = graphs.get(sig)
    if not isinstance(entry, Pipeline):
        entry = graphs[sig] = Pipeline(len(plan.units))
    main = torch.cuda.current_stream(exe.device)
    side = _streams(exe)
    side.wait_stream(main)
    entry.stream = main
    first = any(u is None for u, x in zip(entry.units, plan.units)
                if not x.host and x.no_graph is None)
    exe._warm_branches = first
    exe._unit_graphs = entry
    try:
        with torch.cuda.stream(side):
            exe._step += 1
            results = exe._run_plan(plan, program, feed, fetch_names, scope)
            if return_numpy is not True:
                results = [r.clone() if isinstance(r, torch.Tensor) else r
                           for r in results]
    finally:
        exe._unit_graphs = None
        exe._warm_branches = False
    main.wait_stream(side)
    for r in results:
        if isinstance(r, torch.Tensor) and r.is_cuda:
            r.record_stream(main)
    return exe._return(results, return_numpy)


# ------------------------------------------------------ the auto-bucket
class CapturedCount(_Replayed):
    """The trip count of a plan's auto-bucketed whiles captured in a
    CUDA graph: the ops before the last of them run forward-only and
    each of them to its end as a WHILE node, whose counter is its trips
    (the node indices in ``trips``)."""

    __slots__ = ('trips',)

    def replay(self, feed, step):
        self._feed(feed, step)
        self.graph.replay()
        self._queue_reads()
        torch.cuda.current_stream(self.device).synchronize()
        self._count()
        counts = self.nodes[1].tolist()
        return [counts[k] for k in self.trips]


def _bucket(trips):
    bucket = 1
    while bucket < max(trips, 1):
        bucket *= 2
    return bucket


def count_buckets(exe, plan, program, feed, scope, sig):
    """The buckets of the plan's auto-bucketed whiles for this step,
    stamped as max_trip_count on each while's bucket group (JAX:
    fluid/executor.py:2251 ``_run_bucket_count``): their trips counted
    on the device before the step, one integer a while read on the host,
    each rounded up to a power of two.  The count of a signature runs
    eagerly first, is captured at its second run and replayed after
    (``CapturedCount``); the step then replays the graph of its
    buckets."""
    graphs = _graphs(plan, scope)
    key = ('bucket count',) + sig
    entry = graphs.get(key)
    step = exe._step + 1
    if isinstance(entry, CapturedCount) and not entry.valid(scope):
        compile_cache.count('executor/graph_stale')
        entry = None
    if isinstance(entry, CapturedCount):
        trips = entry.replay(feed, step)
    elif entry is _SEEN:
        entry = graphs[key] = _capture_count(exe, plan, program, feed,
                                             scope, step)
        trips = entry.replay(feed, step)
    else:
        graphs[key] = _SEEN
        trips = exe._count_trips(plan, program, feed, scope, step)
    buckets = tuple(_bucket(t) for t in trips)
    for op, bucket in zip(plan.buckets, buckets):
        gid = op.attrs['__bucket_group__']
        for o in op.block.ops:
            if o.attrs.get('__bucket_group__') == gid:
                o.attrs['max_trip_count'] = bucket
    return buckets


def _capture_count(exe, plan, program, feed, scope, step):
    side = _streams(exe)
    main = torch.cuda.current_stream(exe.device)
    _to_device_reads(exe, plan, feed, scope)
    cap = CapturedCount()
    cap.device = exe.device
    cap.nan = None
    cap._static_inputs(feed, step)
    env = {n: x for n, (x, _, _) in cap.inputs.items() if n != _STEP}
    cap.trips = cap._capture_graph(
        exe, plan, scope, plan.ops, side, main,
        lambda: exe._count_trips(plan, program, feed, scope, step, env=env,
                                 step_t=cap.inputs[_STEP][0]))
    return cap


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


# ------------------------------------------------------ conditional nodes
# a forward-only while and a conditional_block inside a capture
# (Executor._lower_while / _lower_conditional_block): CUDA graph WHILE and
# IF nodes (ops/kernels/graph_cond.py), so the condition never crosses to
# the host.  Each node's body is captured on a body stream of its own
# depth; its launches go into a manifest of the node, counted at each
# replay times the node's counter (its trips, or 1 where an IF ran).

# conditional nodes one graph may hold
_NODE_COUNTERS = 256


class Nodes(object):
    """The conditional nodes of the graph being captured: `counts`, a
    device counter per node, zeroed where the capture begins (so at the
    start of each replay) and advanced once each time the node's body
    runs; `manifests`, each node's body launches; `depth`, the nesting
    depth of the body being captured."""

    __slots__ = ('counts', 'manifests', 'depth')

    def __init__(self, device):
        self.counts = torch.zeros(_NODE_COUNTERS, dtype=torch.int64,
                                  device=device)
        self.manifests = []
        self.depth = 0


def body_stream(exe, depth):
    """The stream conditional-node bodies of nesting depth `depth` are
    captured on."""
    streams = exe._body_streams
    while len(streams) <= depth:
        streams.append(torch.cuda.Stream(exe.device))
    return streams[depth]


def control_depth(program, ops):
    """How deep `ops`' control-flow ops nest (0: none)."""
    from .executor import _CONTROL_FLOW
    best = 0
    for op in ops:
        sub = op.attrs.get('sub_block')
        if op.type in _CONTROL_FLOW and isinstance(sub, int):
            best = max(best, 1 + control_depth(program,
                                               program.blocks[sub].ops))
    return best


def warm_body_streams(exe, depth):
    """Give each body stream down to `depth` its cuBLAS workspace before
    a capture (a workspace is made at a stream's first product, which
    must not happen inside a body)."""
    main = torch.cuda.current_stream(exe.device)
    for d in range(depth):
        s = body_stream(exe, d)
        s.wait_stream(main)
        with torch.cuda.stream(s):
            a = torch.ones(8, 8, device=exe.device)
            torch.mm(a, a)
            torch.addmm(a, a, a)
            torch.mm(a.bfloat16(), a.bfloat16())
        main.wait_stream(s)


def _body_pool(exe):
    """The memory pool of the conditional-node bodies of the executor's
    graphs.  The allocator takes one routing per pool at a time, and
    the graph's own pool has the capture's; so the bodies allocate from
    a pool of their own, which, like the graphs' pool, their captures
    share (graphs replay one at a time) and which lives as long as the
    executor (its count of users is never given back)."""
    if exe._body_pool is None:
        exe._body_pool = torch.cuda.graph_pool_handle()
    return exe._body_pool


@contextlib.contextmanager
def _route_to_pool(exe):
    """Allocations this thread makes go to the bodies' pool (nested
    bodies' too: the outermost body routes them)."""
    begin = getattr(torch._C, '_cuda_beginAllocateCurrentThreadToPool',
                    None)
    if begin is None:
        raise graph_cond.ConditionalNodeError(
            'conditional nodes need PyTorch\'s '
            '_cuda_beginAllocateCurrentThreadToPool')
    dev, pool = exe.device.index, _body_pool(exe)
    begin(dev, pool)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(dev, pool)


@contextlib.contextmanager
def _node_body(exe, pred, is_while):
    """Inside: the body of a WHILE (`is_while`) or IF node on the
    condition tensor `pred`, added after the work captured on the
    current stream so far; yields the node's handle."""
    nodes = exe._nodes
    k = len(nodes.manifests)
    if k >= _NODE_COUNTERS:
        raise graph_cond.ConditionalNodeError(
            'more than %d conditional nodes in one graph' % _NODE_COUNTERS)
    nodes.manifests.append(None)
    stream = torch.cuda.current_stream(exe.device)
    handle = graph_cond.create_handle(stream)
    graph_cond.set_cond(handle, pred)
    body = body_stream(exe, nodes.depth)
    graph_cond.begin_body(stream, handle, is_while, body)
    nodes.depth += 1
    ok = False
    try:
        route = _route_to_pool(exe) if nodes.depth == 1 else \
            contextlib.nullcontext()
        with route, common.sub_recording() as rec, torch.cuda.stream(body):
            yield handle
            nodes.counts[k:k + 1].add_(1)
        nodes.manifests[k] = rec.launches
        ok = True
    finally:
        nodes.depth -= 1
        try:
            graph_cond.end_body(body)
        except RuntimeError:
            if ok:
                raise


def _carry_buffers(carry):
    """The loop state's buffers: a body graph reads and writes the same
    addresses at every trip."""
    return {n: v.detach().clone() for n, v in carry.items()}


def _assign_carry(bufs, new):
    """Copy a trip's new loop state into the buffers; a value that shares
    storage with a buffer (a carry passed on under another name) is
    copied out first, so no copy reads what another overwrote."""
    held = {b.untyped_storage().data_ptr() for b in bufs.values()}
    staged = {}
    for n, v in new.items():
        b = bufs[n]
        if v is b:
            continue
        if tuple(v.shape) != tuple(b.shape):
            raise RuntimeError(
                'loop state %s changes its shape from %s to %s in a trip: '
                'a graph replays fixed buffers' % (n, tuple(b.shape),
                                                   tuple(v.shape)))
        if v.untyped_storage().data_ptr() in held:
            v = v.clone()
        staged[n] = v
    for n, v in staged.items():
        bufs[n].copy_(v)


def while_node(exe, carry, cond_name, body):
    """A forward-only while captured as a WHILE node: the loop state in
    buffers, `body(bufs)` captured once as the node's body (the new
    state copied into the buffers, then the handle set from the new
    condition).  Returns the buffers, which hold the loop's outputs."""
    bufs = _carry_buffers(carry)
    with _node_body(exe, bufs[cond_name], True) as handle:
        _assign_carry(bufs, body(bufs))
        graph_cond.set_cond(handle, bufs[cond_name])
    return bufs


def warm_branch(exe, op, carry, body):
    """Build what the branch of conditional_block `op` launches without
    running it, where a signature's first run does not take it:
    `body(carry)` captured in relaxed mode into a graph that is thrown
    away (PyTorch's cudagraph_conditional_nodes warms a cond so), its
    nested control flow as nodes and its launches uncounted.  So nothing
    in the branch is first built inside the capture that replays, and a
    branch that is valid only where its condition holds never runs.  A
    branch that cannot be captured is left to that capture, which then
    fails with the reason (the signature runs eagerly)."""
    if exe.device.type != 'cuda':
        return
    main = torch.cuda.current_stream(exe.device)
    # nested bodies are captured on the body streams below `depth`
    depth = control_depth(op.block.program, [op])
    warm_body_streams(exe, depth + 1)
    stream = body_stream(exe, depth)
    stream.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    nodes, exe._nodes = exe._nodes, Nodes(exe.device)
    try:
        with common.recording_launches(main), torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode='relaxed')
            try:
                body(dict(carry))
            finally:
                graph.capture_end()
    except graph_cond.ConditionalNodeError:
        raise
    except Exception:   # noqa: S110  (the real capture names it)
        pass
    finally:
        exe._nodes = nodes
    del graph
    main.wait_stream(stream)


def if_node(exe, carry, pred, body):
    """A conditional_block captured as an IF node: the outputs' buffers
    hold their entry values, which `body(bufs)` overwrites when `pred`
    holds."""
    bufs = _carry_buffers(carry)
    with _node_body(exe, pred, False):
        _assign_carry(bufs, body(bufs))
    return bufs


def node_counts(nodes):
    """(device counter slice, pinned host buffer) of a capture's nodes,
    or None without nodes."""
    if nodes is None or not nodes.manifests:
        return None
    n = len(nodes.manifests)
    return nodes.counts[:n], torch.empty(n, dtype=torch.int64,
                                         pin_memory=True)


def count_node_replays(manifests, host_counts):
    """Add each node body's launches, times the runs the replay counted,
    to the replayed launches."""
    for m, times in zip(manifests, host_counts.tolist()):
        if m and times:
            common.add_replays({k: n * times for k, n in m.items()})

"""Operator registry: op type -> PyTorch lowering rule.

Reference design: REGISTER_OPERATOR / REGISTER_OP_*_KERNEL macros
(framework/op_registry.h:223,265,268) + OpInfoMap (framework/op_info.h:124)
+ per-op GradOpDescMaker (framework/grad_op_desc_maker.h:39).

An op is ONE function on tensors
    fn(ctx, ins: {slot: [Tensor,...]}, attrs: dict) -> {slot: [Tensor,...]}
that the eager executor calls.  Graph-build-time shape/dtype inference
runs the same function on meta tensors (``infer_shapes``), so the IR
never drifts from the lowerings.  The grad op ``<type>_grad`` is
synthesized from the forward lowering by torch.autograd
(``grad_op_def``), with the JAX package's slot convention.
"""

import copy

import numpy as np
import torch

from .kernels.flash_attention import mul32


class Replica(object):
    """One data-parallel replica of ``CompiledProgram.with_data_parallel``
    (fluid/parallel_executor.py): this process's rank in the process
    group of `world` ranks, each fed its own equal share of the global
    batch."""

    __slots__ = ('group', 'rank', 'world')

    def __init__(self, group, rank, world):
        self.group = group
        self.rank = int(rank)
        self.world = int(world)


_M32 = 0xFFFFFFFF

_CONSTANTS = {}


def device_constant(values, device):
    """A tensor of the numpy array `values` on `device`.  On a CUDA
    device the values are uploaded once (the first, eager run of a
    program) and each call returns a copy made on the device, which a
    CUDA graph can capture: a capture cannot copy from host memory.  A
    0-d value stays 0-d (np.ascontiguousarray alone gives it a dim of
    1)."""
    values = np.ascontiguousarray(values).reshape(np.shape(values))
    device = torch.device(device)
    if device.type != 'cuda':
        return torch.as_tensor(values, device=device)
    key = (device, values.dtype.str, values.shape, values.tobytes())
    master = _CONSTANTS.get(key)
    if master is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                'a host constant %s first met inside a CUDA graph capture'
                % (values.shape,))
        master = _CONSTANTS[key] = torch.as_tensor(values, device=device)
    return master.clone()


class LowerCtx(object):
    """Per-op lowering context: the device new tensors go to, the step
    and what is keyed on it, and the two ways a program runs across
    ranks, which ``mode`` names:

    - ``'collective'``: a program the collective transpiler marked (the
      JAX package's ``shard_map`` runner).  ``group`` is the process
      group ring 0 of the collective ops reduces over; every other op is
      the rank's own, ``batch_norm`` included, and ranks draw alike.
    - ``'data_parallel'``: ``with_data_parallel`` (the JAX package's one
      global computation under GSPMD).  ``replica`` is this rank's
      ``Replica``; ``group`` is None, so the collective ops are the
      identity, as outside ``shard_map``.  The ops that reduce over the
      batch take the global batch's values (``batch_norm``), the
      attention-dropout masks are this rank's rows of the global
      batch's, and the dropout op draws per rank.
    - None: one process, every collective the identity.

    The step is a host int (``step``) and, for what the training ops
    draw each step (the attention-dropout seed, the dropout op's mask),
    a value on the device (``step_mix``: the executor's, made once a
    run from its device step, a CUDA graph's static input while one is
    captured), as the JAX package feeds the step as a traced scalar: a
    replayed graph draws the masks of the step it replays.  The random
    initializers of a startup program (``host_draws``: the executor sets
    it for a program that ``program_guard`` or
    ``default_startup_program`` made one) draw on the host from
    ``rng()``, an explicit ``torch.Generator`` seeded from the
    program's ``random_seed``, the op's seed and the step; in any other
    program uniform_random and gaussian_random draw on the device from
    the counter hash under ``sample_seed``, as the other sampling ops
    do.  Neither reproduces the JAX package's threefry bits.

    ``unread`` names the op's output slots that nothing reads (no later
    op, no fetch, not persistable: the executor's run plan says so), which
    the lowering may leave out of its result (``writes``); by default
    every slot is written.
    """

    def __init__(self, step, op_seed=0, prefer_test=False, device=None,
                 random_seed=0, group=None, replica=None, step_mix=None,
                 unread=frozenset(), host_draws=False):
        self.step = step
        self.host_draws = host_draws
        self.unread = frozenset(unread)
        self.group = group
        self.replica = replica
        self.op_seed = int(op_seed)
        self.prefer_test = prefer_test
        self.device = torch.device(device or 'cpu')
        self.random_seed = int(random_seed)
        # c -> mul32(device step, c), or None: made from the host step
        self._step_mix = step_mix

    def writes(self, slot):
        """Whether the op's output slot `slot` is read after it."""
        return slot not in self.unread

    def leaving_out(self, slots):
        """A copy of this context whose op leaves out the output `slots`
        too."""
        ctx = copy.copy(self)
        ctx.unread = self.unread | frozenset(slots)
        return ctx

    @property
    def mode(self):
        if self.replica is not None:
            return 'data_parallel'
        return 'collective' if self.group is not None else None

    def data_parallel(self):
        """This rank's Replica when data parallel over more than one
        rank, else None."""
        r = self.replica
        return r if r is not None and r.world > 1 else None

    def rng(self):
        """A host generator for the random initializers (startup
        programs, ``host_draws``; a CUDA graph never captures an op that
        draws here)."""
        g = torch.Generator(device=self.device)
        seed = (self.random_seed * 1000003 + self.op_seed) * 1000033 + \
            int(self.step)
        if self.replica is not None:
            # in the low 32 bits, which the CPU generator keeps
            seed += self.replica.rank * 0x9E3779B1
        g.manual_seed(seed)
        return g

    def step_mix(self, c):
        """(step * c) mod 2**32 for a constant c < 2**32, as a 0-d int64
        tensor on the context's device."""
        if self._step_mix is not None:
            return self._step_mix(c)
        return mul32(torch.tensor(int(self.step) & _M32, dtype=torch.int64,
                                  device=self.device), c)

    def dropout_seed(self, attrs):
        """The uint32 seed of in-kernel attention dropout as a 0-d int64
        tensor on the device, or None in eval mode (prefer_test lowering
        or a clone-stamped is_test attr): the JAX package's
        (op_seed * 2654435761 mod 2**32) ^ (step * 0x9E3779B9 mod 2**32)
        in uint32 arithmetic, computed from the device step."""
        if self.prefer_test or attrs.get("is_test"):
            return None
        return ((self.op_seed * 2654435761) % (1 << 32)) ^ \
            self.step_mix(0x9E3779B9)

    def dropout_op_seed(self):
        """The uint32 seed of the dropout op's counter hash
        (``hash_keep``) as a 0-d int64 tensor on the device: a host mix
        of the program's random_seed, the op's seed and, in data
        parallel, the rank, xor the device step times 0x85EBCA77."""
        base = (self.random_seed * 1000003 + self.op_seed) * 1000033
        if self.replica is not None:
            base += self.replica.rank * 0x9E3779B1
        base = ((base & _M32) * 0xC2B2AE3D) % (1 << 32)
        return base ^ self.step_mix(0x85EBCA77)

    def sample_seed(self, salt):
        """The uint32 seed of a sampling op's counter hash (nce,
        sample_logits: ``kernels.dropout.hash_bits``) as a 0-d int64
        tensor on the device: a host mix of the program's random_seed,
        the op's seed, its `salt` (the op's seed attr) and, in data
        parallel, the rank, xor the device step times 0x27D4EB2F, so a
        replayed graph draws the samples of the step it replays."""
        base = ((self.random_seed * 1000003 + self.op_seed) * 1000033 +
                int(salt)) * 1000037
        if self.replica is not None:
            base += self.replica.rank * 0x9E3779B1
        base = ((base & _M32) * 0x165667B1) % (1 << 32)
        return base ^ self.step_mix(0x27D4EB2F)


class OpDef(object):
    __slots__ = ("type", "fn", "no_grad_out_slots", "stochastic",
                 "host_random", "host")

    def __init__(self, type, fn, no_grad_out_slots=(), stochastic=False,
                 host_random=False, host=False):
        self.type = type
        self.fn = fn
        # a host op the executor runs between device ops (ops/host_ops.py):
        # fn(ctx, op, ins) -> outs, never recorded by autograd or captured
        self.host = host
        # output slots that carry no gradient (dropout's Mask)
        self.no_grad_out_slots = tuple(no_grad_out_slots)
        # draws randomness without a declared is_test attr: clone
        # (for_test=True) stamps is_test on these so eval is
        # deterministic (framework.Program.clone)
        self.stochastic = stochastic
        # draws from the host generator LowerCtx.rng() in a startup
        # program (LowerCtx.host_draws), which a CUDA graph would freeze:
        # a startup program holding it is never captured
        self.host_random = host_random

    def run(self, ctx, ins, attrs):
        """Invoke the lowering with the AMP dtype rule of the op's marks
        (``_amp_harmonize``).  Grad ops skip it: their fn replays the
        forward through run(), so the casts sit inside the autograd
        graph and the f32 master parameters' gradients come back f32,
        the reference's backward cast op."""
        if not self.type.endswith('_grad'):
            ins = _amp_harmonize(ins, attrs)
        return self.fn(ctx, ins, attrs)


_LOW = (torch.bfloat16, torch.float16)


def _amp_harmonize(ins, attrs):
    """The AMP marks' input casts (reference fp16_utils._insert_cast_op;
    the JAX package's registry._amp_harmonize).  A black op
    (``__amp_black__``) takes bf16 and f16 inputs up to f32.  A gray op
    (``__amp_gray__``) follows a low-precision input: its f32 inputs go
    down to the first low dtype among them.  Without the gray rule
    torch's promotion would take a bf16 activation up to f32 at every
    f32 master-parameter bias add, and everything after it would run in
    f32 without any error."""
    if attrs.get('__amp_black__'):
        return {s: [v.float() if isinstance(v, torch.Tensor) and
                    v.dtype in _LOW else v for v in vs]
                for s, vs in ins.items()}
    if attrs.get('__amp_gray__'):
        low = next((v.dtype for vs in ins.values() for v in vs
                    if isinstance(v, torch.Tensor) and v.dtype in _LOW),
                   None)
        if low is None:
            return ins
        return {s: [v.to(low) if isinstance(v, torch.Tensor) and
                    v.dtype == torch.float32 else v for v in vs]
                for s, vs in ins.items()}
    return ins


_REGISTRY = {}
# Host-level op types: no shape inference and no gradient.  The
# executor skips feed/fetch and the collective rendezvous ops, and runs
# the others (ops/host_ops.py) on the host between device ops.
HOST_OPS = set()


def register(type, no_grad_out_slots=(), stochastic=False,
             host_random=False):
    """Decorator: register `fn(ctx, ins, attrs) -> outs` as op `type`."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, no_grad_out_slots,
                                stochastic=stochastic,
                                host_random=host_random)
        return fn

    return deco


def register_host(type, runs=False):
    """Register a host-level op: one the executor skips (feed/fetch), or
    with `runs` one it runs as fn(ctx, op, ins) -> outs."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, host=runs)
        HOST_OPS.add(type)
        return fn

    return deco


def skipped_by_executor(type):
    """True for the host ops the executor leaves out of a plan."""
    return type in HOST_OPS and not _REGISTRY[type].host


def is_registered(type):
    return type in _REGISTRY or (
        type.endswith("_grad") and type[:-5] in _REGISTRY)


def get(type):
    if type in _REGISTRY:
        return _REGISTRY[type]
    if type.endswith("_grad") and type[:-5] in _REGISTRY:
        d = _REGISTRY[type] = grad_op_def(_REGISTRY[type[:-5]])
        return d
    raise NotImplementedError(
        "operator '%s' has no lowering in paddle_tpu_torch yet (this "
        "slice lowers: %s)" % (type, ', '.join(registered_ops())))


def registered_ops():
    return sorted(_REGISTRY.keys())


# ---------------------------------------------------------------------------
# Generic gradient synthesis
# ---------------------------------------------------------------------------


def grad_op_def(fwd):
    """The grad OpDef of a forward OpDef, by torch.autograd over the
    forward lowering.

    Grad-op calling convention (the JAX package's, after the
    reference's GradOpDescMaker, framework/grad_op_desc_maker.h:39):
      inputs : every forward input slot (primal values) +
               'GRAD::<out_slot>' for each available output gradient
      outputs: 'GRAD::<in_slot>' for every forward input, zeros where
               an input gets no gradient.
    The forward is replayed with the same context (op seed and step),
    so a stochastic op draws the same mask; a forward that runs its own
    autograd.Function (flash attention, the embedding gather) takes
    that Function's backward kernels.  The replay leaves out the output
    slots that carry no gradient (dropout's Mask): nothing reads them."""

    def fn(ctx, ins, attrs):
        ctx = ctx.leaving_out(fwd.no_grad_out_slots)
        primal_slots = sorted(s for s in ins if not s.startswith("GRAD::"))
        with torch.enable_grad():
            primals = {s: [v.detach().requires_grad_()
                           if v.is_floating_point() else v
                           for v in ins[s]] for s in primal_slots}
            outs = fwd.run(ctx, primals, attrs)
            ys, cts = [], []
            for s, vs in outs.items():
                g_in = ins.get("GRAD::" + s)
                if s in fwd.no_grad_out_slots or g_in is None:
                    continue
                for v, g in zip(vs, g_in):
                    if g is not None and v.requires_grad:
                        ys.append(v)
                        cts.append(g.to(v.dtype))
            xs = [v for s in primal_slots for v in primals[s]
                  if v.requires_grad]
            grads = (torch.autograd.grad(ys, xs, cts, allow_unused=True)
                     if ys and xs else [None] * len(xs))
        by_id = {id(x): g for x, g in zip(xs, grads)}
        result = {}
        for s in primal_slots:
            row = []
            for v in primals[s]:
                g = by_id.get(id(v))
                row.append(torch.zeros_like(v).detach() if g is None else g)
            result["GRAD::" + s] = row
        return result

    return OpDef(fwd.type + "_grad", fn)


# ---------------------------------------------------------------------------
# Shape inference (the lowering run on meta tensors)
# ---------------------------------------------------------------------------

# Sentinel concrete size substituted for -1 (dynamic batch) dims during
# graph-build-time shape inference; output dims equal to it map back to
# -1.  The same prime as the JAX package, so both infer the same shapes.
_DYN_SENTINEL = 86243


def infer_shapes(op_type, in_specs, attrs):
    """in_specs: {slot: [(shape, dtype), ...]} with -1 allowed in shapes.
    Returns {slot: [(shape, torch dtype), ...]} for outputs, -1 restored.

    Only dims EQUAL to the sentinel map back to -1; products of it
    (layer_norm's Mean row count) stay literal, as in the JAX package,
    so downstream reshape arithmetic stays consistent."""
    from ..fluid import core
    opdef = get(op_type)
    has_dyn = False
    ins = {}
    for slot, specs in in_specs.items():
        row = []
        for shape, dtype in specs:
            shape = tuple(int(d) for d in shape)
            if -1 in shape:
                has_dyn = True
                shape = tuple(_DYN_SENTINEL if d == -1 else d for d in shape)
            row.append(torch.empty(shape, dtype=core.convert_dtype(dtype),
                                   device='meta'))
        ins[slot] = row
    ctx = LowerCtx(step=0, op_seed=int(attrs.get("__op_seed__", 0)),
                   prefer_test=True, device='meta')
    out = opdef.run(ctx, ins, attrs)
    result = {}
    for slot, vs in out.items():
        row = []
        for v in vs:
            shape = tuple(v.shape)
            if has_dyn:
                shape = tuple(-1 if d == _DYN_SENTINEL else d for d in shape)
            row.append((shape, v.dtype))
        result[slot] = row
    return result

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

import torch


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


class LowerCtx(object):
    """Per-op lowering context: the device new tensors go to, a
    deterministic per-(op, step) random generator, and the two ways a
    program runs across ranks, which ``mode`` names:

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

    Random draws come from an explicit ``torch.Generator`` seeded from
    the program's ``random_seed``, the op's seed, the step and, in data
    parallel, the rank (rank 0 draws as one process does); they do not
    reproduce the JAX package's threefry bits.
    """

    def __init__(self, step, op_seed=0, prefer_test=False, device=None,
                 random_seed=0, group=None, replica=None):
        self.step = step
        self.group = group
        self.replica = replica
        self.op_seed = int(op_seed)
        self.prefer_test = prefer_test
        self.device = torch.device(device or 'cpu')
        self.random_seed = int(random_seed)

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
        g = torch.Generator(device=self.device)
        seed = (self.random_seed * 1000003 + self.op_seed) * 1000033 + \
            int(self.step)
        if self.replica is not None:
            # in the low 32 bits, which the CPU generator keeps
            seed += self.replica.rank * 0x9E3779B1
        g.manual_seed(seed)
        return g

    def dropout_seed(self, attrs):
        """uint32 seed for in-kernel dropout, or None in eval mode
        (prefer_test lowering or a clone-stamped is_test attr)."""
        if self.prefer_test or attrs.get("is_test"):
            return None
        return ((self.op_seed * 2654435761) % (1 << 32) ^
                (int(self.step) * 0x9E3779B9) % (1 << 32))


class OpDef(object):
    __slots__ = ("type", "fn", "no_grad_out_slots", "stochastic")

    def __init__(self, type, fn, no_grad_out_slots=(), stochastic=False):
        self.type = type
        self.fn = fn
        # output slots that carry no gradient (dropout's Mask)
        self.no_grad_out_slots = tuple(no_grad_out_slots)
        # draws randomness without a declared is_test attr: clone
        # (for_test=True) stamps is_test on these so eval is
        # deterministic (framework.Program.clone)
        self.stochastic = stochastic

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
# Op types the executor handles itself (feed/fetch), never lowered.
HOST_OPS = set()


def register(type, no_grad_out_slots=(), stochastic=False):
    """Decorator: register `fn(ctx, ins, attrs) -> outs` as op `type`."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, no_grad_out_slots,
                                stochastic=stochastic)
        return fn

    return deco


def register_host(type):
    """Register a host-level op (feed/fetch)."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn)
        HOST_OPS.add(type)
        return fn

    return deco


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
    that Function's backward kernels."""

    def fn(ctx, ins, attrs):
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

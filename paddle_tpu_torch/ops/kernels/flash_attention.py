"""Flash attention, forward and backward: the hand-written CUDA kernels
(csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu) and their
plain PyTorch versions, joined by a ``torch.autograd.Function``.

Public layout as in the JAX package: q, k, v [B, T, H, D], an optional
additive key bias [B, T] (a padding mask as 0 / -10000), -> O
[B, T, H, D] (and lse [B, H, T] from ``flash_attention_with_lse``).
``dropout_rate > 0`` drops attention probabilities after the softmax
(training): each element's keep bit comes from a counter hash of the
uint32 ``dropout_seed`` and the element's (head, query, key) position,
the JAX package's ``_dropout_keep``, so the forward kernel, the backward
kernel and the plain version draw the same mask bit for bit.
``dropout_g_offset`` (the JAX kernels' argument) is added to the head
index b*H + h: a data-parallel rank with local batch B passes
rank * B * H, so its masks are its rows of the global batch's.  There is
no sequence-length floor: every call on CUDA tensors launches the
kernels.  The seed is an int or a 0-d integer tensor holding a value in
[0, 2**32) (the executor's, computed on the device from the step); the
kernels read it from device memory, once a thread at their start, so a
CUDA graph that captured them draws the masks of each replay's seed.

Two routes, by the inputs' dtype.  f32: f32-accurate products (3xTF32
on the tensor cores).  bf16: what the Pallas kernels compute for bf16
inputs (paddle_tpu/ops/pallas/flash_attention.py:130-181 and
:410-453): the products take bf16 operands and accumulate in f32, the
softmax runs in f32 with its normalizer summing the unrounded
probabilities, and the operands made inside the kernels are rounded to
bf16 where they enter a product: the dropped and rescaled P of P V and
of dV, dS of dK and dQ.  O, dQ, dK and dV are rounded once to bf16;
lse and the bias cotangent stay f32.  The plain versions take the same
rounding points.
"""

import ctypes
import math

import torch

from . import common

FWD_SOURCE = 'flash_attention_fwd.cu'
BWD_SOURCE = 'flash_attention_bwd.cu'
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

common.register_kernel(
    'flash_attention',
    source=FWD_SOURCE,
    plain='ops.kernels.flash_attention.flash_attention_plain '
          '(einsum, bias, mask, softmax, dropout mask, einsum in f32)',
    replaces='paddle_tpu/ops/pallas/flash_attention.py:121 '
             '_flash_fwd_kernel',
    doc='f32: a block of 4 warps per 64-row Q tile, S = Q K^T and O += '
        'P V as mma.sync TF32 with the 3xTF32 split, K, V and the bias '
        'through a two-stage cp.async ring; bf16: a producer warp feeding '
        'Q, K and V tiles by TMA through an mbarrier ring to warpgroups '
        'of 64 rows, S and P V as wgmma (P from registers, rounded to '
        'bf16); online softmax in the accumulators, P fed back as the A '
        'operand with its in-kernel dropout hash; no atomics',
    op_types=('fused_multihead_attention',))

common.register_kernel(
    'flash_attention_bwd',
    source=BWD_SOURCE,
    plain='ops.kernels.flash_attention.flash_attention_bwd_plain '
          '(autograd of flash_attention_plain)',
    replaces='paddle_tpu/ops/pallas/flash_attention.py:361 '
             '_flash_bwd_fused_kernel (and :200 + :273, the two-pass '
             'dq / dkv kernels)',
    doc='delta pass, then a dK/dV kernel over key tiles and a dQ '
        'kernel over query tiles; f32: mma.sync TF32 with the 3xTF32 '
        'split, streamed tiles through a two-stage cp.async ring; bf16: '
        'wgmma on TMA-fed tiles (a producer warp, an mbarrier ring), P '
        'and dS rounded to bf16 as A operands from registers; no atomics',
    op_types=('fused_multihead_attention_grad',))

_M32 = 0xFFFFFFFF


def keep_threshold(rate):
    """24-bit integer threshold of the keep probability 1 - rate (the
    JAX package's ``_keep_threshold``)."""
    return int(round((1.0 - float(rate)) * (1 << 24)))


def mul32(a, c):
    """(a * c) mod 2**32 for an int64 tensor a in [0, 2**32) and a
    constant c < 2**32, in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _seed_value(seed, device):
    """The uint32 seed as an int, or as a 0-d int64 tensor on `device`
    where it is a tensor (whose value is in [0, 2**32) already)."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64)
    return int(seed) & _M32


def dropout_keep_plain(seed, b, h, tq, tk, rate, device=None, g_offset=0):
    """[b, h, tq, tk] bool keep mask: the counter hash of the kernels
    (csrc/dropout_hash.cuh) at head g = b*H + h + g_offset, query and
    key positions, in int64 arithmetic reduced mod 2**32 (the JAX
    package's ``dropout_keep_dense`` with ``g_off``)."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)

    g = (ar(b)[:, None] * h + ar(h)[None, :] + int(g_offset)) & _M32
    g = g[:, :, None, None]
    qpos = ar(tq)[None, None, :, None]
    kpos = ar(tk)[None, None, None, :]
    x = (mul32(qpos, 0x9E3779B1) ^ mul32(kpos, 0x85EBCA77) ^
         mul32(g, 0xC2B2AE3D) ^ _seed_value(seed, device))
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >> 8) < keep_threshold(rate)


def _scores(q, k, causal, key_bias):
    """S = Q K^T / sqrt(D) + bias [B, H, T, T] in f32, -inf where the
    causal mask hides a key."""
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum('bthd,bshd->bhts', q.float(), k.float()) * (
        1.0 / (d ** 0.5))
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if causal:
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float('-inf'))
    return s


def flash_attention_plain(q, k, v, causal=False, key_bias=None,
                          dropout_rate=0.0, dropout_seed=None,
                          dropout_g_offset=0):
    """(O [B, T, H, D] in q's dtype, lse [B, H, T] f32), computed in f32;
    differentiable by autograd for f32 inputs.

    Rows whose keys are all masked follow the JAX kernel's rule
    (m_safe = 0, l_safe = max(l, 1e-20)): O = 0, lse = log(1e-20).
    With dropout the normalizer and lse use the un-dropped
    probabilities; only the V-weighting is masked and scaled.  bf16
    inputs take the Pallas kernel's rounding points: the unnormalized
    p = exp(s - max), dropped and rescaled, is rounded to bf16 before
    P V, and O is that product over l, rounded to bf16."""
    b, t, h, d = q.shape
    s = _scores(q, k, causal, key_bias)
    # the max only stabilizes: O and lse do not depend on it
    m = s.amax(dim=-1, keepdim=True).detach()
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    lse = (m_safe + torch.log(l_safe)).squeeze(-1)
    keep = None
    if dropout_rate:
        keep = dropout_keep_plain(dropout_seed, b, h, t, t, dropout_rate,
                                  q.device, dropout_g_offset)
    if q.dtype == torch.bfloat16:
        if keep is not None:
            p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
        o = torch.einsum('bhts,bshd->bthd', p.to(torch.bfloat16).float(),
                         v.float())
        return (o / l_safe.squeeze(-1).transpose(1, 2)[..., None]).to(
            q.dtype), lse
    pn = p / l_safe
    if keep is not None:
        pn = torch.where(keep, pn * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.einsum('bhts,bshd->bthd', pn, v.float())
    return o.to(q.dtype), lse


def _bwd_plain_bf16(q, k, v, key_bias, do, dlse, causal, dropout_rate,
                    dropout_seed, bias_grad, dropout_g_offset):
    """The bf16 backward at the Pallas kernel's rounding points
    (flash_attention.py:410-453): P = exp(S - lse) and dP = dO V^T in
    f32 from the bf16 operands, dV = P_drop^T dO with P_drop rounded to
    bf16, dS = P (dP_drop - delta + dlse) in f32 with delta =
    rowsum(dO O) of the bf16 O, dK = dS^T Q and dQ = dS K with dS
    rounded to bf16, each times 1 / sqrt(D); the bias cotangent sums dS
    in f32."""
    b, t, h, d = q.shape
    bf16 = torch.bfloat16
    scale = 1.0 / (d ** 0.5)
    o, lse = flash_attention_plain(q, k, v, causal, key_bias, dropout_rate,
                                   dropout_seed, dropout_g_offset)
    s = _scores(q, k, causal, key_bias)
    p = torch.where(torch.isfinite(s), torch.exp(s - lse[..., None]), 0.0)
    dof = torch.zeros(o.shape, device=q.device) if do is None else do.float()
    dp = torch.einsum('bthd,bshd->bhts', dof, v.float())
    pu = p
    if dropout_rate:
        keep = dropout_keep_plain(dropout_seed, b, h, t, t, dropout_rate,
                                  q.device, dropout_g_offset)
        inv = 1.0 / (1.0 - dropout_rate)
        pu = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    dv = torch.einsum('bhts,bthd->bshd', pu.to(bf16).float(), dof)
    dd = dp - torch.sum(dof * o.float(), dim=-1).transpose(1, 2)[..., None]
    if dlse is not None:
        dd = dd + dlse.float()[..., None]
    ds = p * dd
    dsb = ds.to(bf16).float()
    dk = torch.einsum('bhts,bthd->bshd', dsb, q.float()) * scale
    dq = torch.einsum('bhts,bshd->bthd', dsb, k.float()) * scale
    dbias = ds.sum(dim=(1, 2)) if bias_grad else None
    return dq.to(bf16), dk.to(bf16), dv.to(bf16), dbias


def flash_attention_bwd_plain(q, k, v, key_bias, do, dlse, causal=False,
                              dropout_rate=0.0, dropout_seed=None,
                              bias_grad=False, dropout_g_offset=0):
    """The backward's plain version for the cotangents do of O and dlse
    of lse (either may be None) -> (dq, dk, dv, dbias [B, T] f32 or
    None): for f32 inputs autograd of flash_attention_plain (the same
    mask), for bf16 inputs the Pallas kernel's rounding points
    (``_bwd_plain_bf16``)."""
    if q.dtype == torch.bfloat16:
        return _bwd_plain_bf16(q, k, v, key_bias, do, dlse, causal,
                               dropout_rate, dropout_seed,
                               bias_grad and key_bias is not None,
                               dropout_g_offset)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bias = key_bias
        if bias_grad:
            bias = key_bias.detach().float().requires_grad_()
            leaves.append(bias)
        o, lse = flash_attention_plain(leaves[0], leaves[1], leaves[2],
                                       causal, bias, dropout_rate,
                                       dropout_seed, dropout_g_offset)
        outs, cts = [o], [torch.zeros_like(o) if do is None else do]
        if dlse is not None:
            outs.append(lse)
            cts.append(dlse.float())
        grads = torch.autograd.grad(outs, leaves, cts, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return tuple(grads[:3]) + ((grads[3] if bias_grad else None),)


def _check(q, k, v, key_bias):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError('q, k, v must share one [B, T, H, D] shape, got '
                         '%s %s %s' % (tuple(q.shape), tuple(k.shape),
                                       tuple(v.shape)))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError('flash attention takes f32 or bf16 q/k/v of one '
                        'dtype, got %s %s %s' % (q.dtype, k.dtype, v.dtype))
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError('head dim %d: the kernel is built for %s'
                         % (q.shape[-1], HEAD_DIMS))
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.stride(-1) != 1:
            raise ValueError('%s must be contiguous in its head dim' % name)
    if key_bias is not None and tuple(key_bias.shape) != (q.shape[0],
                                                          q.shape[1]):
        raise ValueError('key_bias must be [B, T] = %s, got %s'
                         % ((q.shape[0], q.shape[1]),
                            tuple(key_bias.shape)))


def _dropout_args(rate, seed, g_offset, device):
    """(flag, seed, head-index offset, threshold, 1 / (1 - rate)) for
    the C launchers; the seed is a 0-d int64 tensor on `device` (made
    there from an int seed), whose address the kernels take, or None
    without dropout."""
    if not rate:
        return 0, None, 0, 0, 1.0
    if seed is None:
        raise ValueError('dropout_rate > 0 needs a dropout_seed')
    seed = _seed_value(seed, device)
    if not isinstance(seed, torch.Tensor):
        # a fill on the device, which a CUDA graph can capture
        seed = torch.full((), seed, dtype=torch.int64, device=device)
    return (1, seed.contiguous(), int(g_offset) & _M32,
            keep_threshold(rate), 1.0 / (1.0 - rate))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _copy_aligned(x):
    """x, or an aligned copy of it when a row of it that the kernels
    copy with 16-byte cp.async would not start on 16 bytes."""
    step = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and all(st % step == 0
                                      for st in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    out = []
    for x in tensors:
        out += [x.stride(0), x.stride(1), x.stride(2)]
    return (ctypes.c_longlong * len(out))(*out)


def flash_attention_kernel(q, k, v, causal=False, key_bias=None,
                           dropout_rate=0.0, dropout_seed=None,
                           dropout_g_offset=0):
    """The forward CUDA kernel on tensors of one CUDA device:
    (O [B, T, H, D] in q's dtype, lse [B, H, T] f32)."""
    _check(q, k, v, key_bias)
    drop, seed, g_off, threshold, inv_keep = _dropout_args(
        dropout_rate, dropout_seed, dropout_g_offset, q.device)
    b, t, h, d = q.shape
    dev = q.device
    q, k, v = [_copy_aligned(x) for x in (q, k, v)]
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=dev)
    lib = common.library(FWD_SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if key_bias is None else key_bias.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), b, h, t, d,
                 _DTYPE_CODES[q.dtype], int(bool(causal)),
                 1.0 / math.sqrt(d), _strides(q, k, v, o), drop,
                 _ptr(seed), g_off, threshold, inv_keep,
                 common.stream_ptr(dev))
    common.check_launch('flash_attention', lib, err)
    return o, lse.view(b, h, t)


def flash_attention_bwd_kernel(q, k, v, key_bias, o, lse, do, dlse,
                               causal=False, dropout_rate=0.0,
                               dropout_seed=None, bias_grad=False,
                               dropout_g_offset=0):
    """The backward CUDA kernels on tensors of one CUDA device: the
    cotangents of q, k, v (each [B, T, H, D] in q's dtype) and, with
    bias_grad, of key_bias ([B, T] f32, summed over heads), from the
    forward's O and lse [B, H, T] and the cotangents do of O and dlse
    of lse (None: zero)."""
    _check(q, k, v, key_bias)
    drop, seed, g_off, threshold, inv_keep = _dropout_args(
        dropout_rate, dropout_seed, dropout_g_offset, q.device)
    b, t, h, d = q.shape
    dev = q.device
    if do is None:
        do = torch.zeros_like(o)
    for name, x in (('o', o), ('do', do)):
        if tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype:
            raise ValueError('%s must be [B, T, H, D] %s like q, got %s %s'
                             % (name, q.dtype, tuple(x.shape), x.dtype))
    o = o if o.stride(-1) == 1 else o.contiguous()
    do = _copy_aligned(do if do.stride(-1) == 1 else do.contiguous())
    q, k, v = [_copy_aligned(x) for x in (q, k, v)]
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
    lse = lse.to(torch.float32).reshape(b * h, t).contiguous()
    if dlse is not None:
        dlse = dlse.to(torch.float32).reshape(b * h, t).contiguous()
    dq, dk, dv = [torch.empty((b, t, h, d), dtype=q.dtype, device=dev)
                  for _ in range(3)]
    delta = torch.empty((b * h, t), dtype=torch.float32, device=dev)
    dbias_bh = (torch.empty((b * h, t), dtype=torch.float32, device=dev)
                if bias_grad and key_bias is not None else None)
    lib = common.library(BWD_SOURCE)
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), _ptr(key_bias), lse.data_ptr(), _ptr(dlse),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), _ptr(dbias_bh), b, h, t, d,
                 _DTYPE_CODES[q.dtype], int(bool(causal)),
                 1.0 / math.sqrt(d), _strides(q, k, v, o, do, dq, dk, dv),
                 drop, _ptr(seed), g_off, threshold, inv_keep,
                 common.stream_ptr(dev))
    common.check_launch('flash_attention_bwd', lib, err)
    dbias = None if dbias_bh is None else dbias_bh.view(b, h, t).sum(1)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """(O, lse) with the flash backward: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal, rate, seed, g_offset):
        if common.use_kernel(q, k, v, key_bias):
            o, lse = flash_attention_kernel(q, k, v, causal, key_bias,
                                            rate, seed, g_offset)
        else:
            o, lse = flash_attention_plain(q, k, v, causal, key_bias, rate,
                                           seed, g_offset)
        ctx.save_for_backward(q, k, v, key_bias, o, lse)
        ctx.causal, ctx.rate, ctx.seed = causal, rate, seed
        ctx.g_offset = g_offset
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, key_bias, o, lse = ctx.saved_tensors
        bias_grad = key_bias is not None and ctx.needs_input_grad[3]
        if do is None and dlse is None:
            return (None,) * 8
        if common.use_kernel(q, k, v, key_bias):
            dq, dk, dv, dbias = flash_attention_bwd_kernel(
                q, k, v, key_bias, o, lse, do, dlse, ctx.causal, ctx.rate,
                ctx.seed, bias_grad, ctx.g_offset)
        else:
            dq, dk, dv, dbias = flash_attention_bwd_plain(
                q, k, v, key_bias, do, dlse, ctx.causal, ctx.rate,
                ctx.seed, bias_grad, ctx.g_offset)
        if dbias is not None:
            dbias = dbias.to(key_bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None


def _flash(q, k, v, causal, key_bias, dropout_rate, dropout_seed,
           dropout_g_offset):
    rate = float(dropout_rate or 0.0)
    if rate and dropout_seed is None:
        raise ValueError('dropout_rate > 0 needs a dropout_seed')
    o, lse = _FlashAttention.apply(q, k, v, key_bias, bool(causal), rate,
                                   dropout_seed, int(dropout_g_offset))
    return o, lse


def flash_attention(q, k, v, causal=False, key_bias=None, dropout_rate=0.0,
                    dropout_seed=None, dropout_g_offset=0):
    """q, k, v: [B, T, H, D]; key_bias: optional [B, T] additive score
    bias -> [B, T, H, D].  dropout_rate > 0 needs a uint32
    dropout_seed (an int or a 0-d integer tensor); dropout_g_offset
    shifts the mask's head index."""
    return _flash(q, k, v, causal, key_bias, dropout_rate, dropout_seed,
                  dropout_g_offset)[0]


def flash_attention_with_lse(q, k, v, causal=False, key_bias=None,
                             dropout_rate=0.0, dropout_seed=None,
                             dropout_g_offset=0):
    """Like flash_attention but also returns the per-row log-sum-exp
    [B, H, T] (f32, of the un-dropped probabilities), the merge state
    for blockwise/ring composition; both outputs are differentiable."""
    return _flash(q, k, v, causal, key_bias, dropout_rate, dropout_seed,
                  dropout_g_offset)

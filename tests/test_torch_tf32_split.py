"""The numerical design of the flash-attention backward kernel
(csrc/flash_attention_bwd.cu), checked on the CPU: its five products
(S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) run on
TF32 tensor cores with the 3xTF32 split, x = big + small, a product
a_big b_big + a_big b_small + a_small b_big with f32 accumulation.
The kernel takes big = x truncated to TF32 (its 13 low bits cleared)
and small = x - big, which the tensor core reads truncated in turn;
the split with big rounded as cvt.rna.tf32.f32 rounds (to nearest,
ties away from zero) is checked beside it.  Emulated here in numpy at
one BERT-base head (T = 512, D = 64, a padding bias, the dropout mask
of dropout_keep_plain), either split holds dQ, dK, dV and the bias
cotangent to the plain f32 backward within the limit chip_smoke.py
applies to the kernel, 1e-4 * max(1, max|plain|).  How far a single
TF32 product (operands rounded as cvt.rna rounds) falls from the plain
backward is printed beside it (not asserted).

The forward kernel (csrc/flash_attention_fwd.cu) runs its two products
(S = Q K^T and O += P V) the same way, with the online softmax over
64-key tiles in f32; emulated at the same head, with and without the
dropout mask, it holds O and lse to flash_attention_plain within K1's
limit, 1e-4 (a single TF32 product's miss printed beside it).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import flash_attention as fa_k

T, D = 512, 64
LIMIT = 1e-4


def tf32_rna(x):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: half a TF32 ulp added to the magnitude bits, 13 bits
    cleared."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def tf32_trunc(x):
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def split(x, rounding=tf32_trunc):
    """(big, small) as the tensor core reads them: big = x in TF32
    (truncated, as the kernel splits, or rounded), small = x - big
    truncated to TF32."""
    big = rounding(x)
    return big, tf32_trunc(np.asarray(x, np.float32) - big)


def mm3(a, b, rounding=tf32_trunc):
    """a @ b as three TF32 products with exact products and f32 output
    (the accumulation in f64 here, rounded once)."""
    ab, as_ = [y.astype(np.float64) for y in split(a, rounding)]
    bb, bs = [y.astype(np.float64) for y in split(b, rounding)]
    return (ab @ bb + ab @ bs + as_ @ bb).astype(np.float32)


def mm1(a, b):
    """a @ b as one TF32 product."""
    return (tf32_rna(a).astype(np.float64) @
            tf32_rna(b).astype(np.float64)).astype(np.float32)


def backward(mm, q, k, v, bias, do, lse, delta, keep, rate):
    """The kernel's backward at one head with products `mm`, element-wise
    work in f32 as the kernel does it -> dq, dk, dv, dbias."""
    scale = np.float32(1.0 / np.sqrt(D))
    s = mm(q, k.T) * scale + bias[None, :]
    p = np.exp(s - lse[:, None]).astype(np.float32)
    dp = mm(do, v.T)
    pu, dpu = p, dp
    if rate:
        inv = np.float32(1.0 / (1.0 - rate))
        pu = np.where(keep, p * inv, np.float32(0))
        dpu = np.where(keep, dp * inv, np.float32(0))
    ds = (p * (dpu - delta[:, None])).astype(np.float32)
    return (mm(ds, k) * scale, mm(ds.T, q) * scale, mm(pu.T, do),
            ds.sum(0, dtype=np.float32))


def test_tf32_rounding_ties_away_from_zero():
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                  1 + 1.5 * ulp, 3.0, 0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)


@pytest.mark.parametrize('rounding,big_err,err', [
    (tf32_trunc, 2.0 ** -10, 2.0 ** -20), (tf32_rna, 2.0 ** -11, 2.0 ** -21)])
def test_split_keeps_f32_accuracy(rounding, big_err, err):
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * 10
    big, small = split(x, rounding)
    assert np.all(tf32_trunc(big) == big) and np.all(tf32_trunc(small) == small)
    # big alone is off by up to a TF32 ulp (half of one rounded); big +
    # small by a TF32 ulp of small
    assert np.max(np.abs(big - x) / np.abs(x)) <= big_err
    got = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
    assert np.max(got) <= err


@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_three_tf32_products_hold_the_backward_to_its_limit(rate):
    rng = np.random.RandomState(6)
    q, k, v, do = [rng.randn(T, D).astype(np.float32) for _ in range(4)]
    bias = np.where(np.arange(T) < 400, 0.0, -10000.0).astype(np.float32)
    seed = 1234

    def t(x):
        return torch.from_numpy(x)[None, :, None, :]

    bt = torch.from_numpy(bias)[None]
    o, lse = fa_k.flash_attention_plain(t(q), t(k), t(v), False, bt, rate,
                                        seed)
    want = fa_k.flash_attention_bwd_plain(t(q), t(k), t(v), bt, t(do), None,
                                          False, rate, seed, bias_grad=True)
    want = [w.reshape(w.shape[1], -1).squeeze(-1).numpy() if w.dim() == 4
            else w.reshape(-1).numpy() for w in want]
    lse = lse.reshape(T).numpy()
    delta = (do * o.reshape(T, D).numpy()).sum(1, dtype=np.float32)
    keep = (fa_k.dropout_keep_plain(seed, 1, 1, T, T, rate)[0, 0].numpy()
            if rate else None)
    errs = {}
    for name, mm in (('3xTF32', mm3),
                     ('3xTF32 rna', lambda a, b: mm3(a, b, tf32_rna)),
                     ('1xTF32', mm1)):
        got = backward(mm, q, k, v, bias, do, lse, delta, keep, rate)
        errs[name] = [float(np.max(np.abs(g - w)) /
                            max(1.0, float(np.max(np.abs(w)))))
                      for g, w in zip(got, want)]
    print('rate %.1f, max|err| / max(1, max|plain|) of dQ, dK, dV, dbias '
          '(limit %g): %s' % (rate, LIMIT, '; '.join(
              '%s %s' % (k, ['%.2e' % e for e in v]) for k, v in
              errs.items())))
    assert max(errs['3xTF32']) <= LIMIT
    assert max(errs['3xTF32 rna']) <= LIMIT


def forward(mm, q, k, v, bias, keep, rate, tile=64):
    """The forward kernel's online softmax at one head, 64-key tiles,
    products `mm` and element-wise work in f32 -> O, lse."""
    scale = np.float32(1.0 / np.sqrt(D))
    m = np.full(T, -np.inf, np.float32)
    l = np.zeros(T, np.float32)
    o = np.zeros((T, D), np.float32)
    for k0 in range(0, T, tile):
        s = mm(q, k[k0:k0 + tile].T) * scale + bias[None, k0:k0 + tile]
        m_new = np.maximum(m, s.max(1))
        corr = np.where(np.isfinite(m), np.exp(m - m_new), np.float32(0))
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        l = (l * corr + p.sum(1, dtype=np.float32)).astype(np.float32)
        if rate:
            p = np.where(keep[:, k0:k0 + tile],
                         p * np.float32(1.0 / (1.0 - rate)), np.float32(0))
        o = (o * corr[:, None] + mm(p, v[k0:k0 + tile])).astype(np.float32)
        m = m_new
    return o / l[:, None], m + np.log(l)


@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_three_tf32_products_hold_the_forward_to_its_limit(rate):
    rng = np.random.RandomState(8)
    q, k, v = [rng.randn(T, D).astype(np.float32) for _ in range(3)]
    bias = np.where(np.arange(T) < 400, 0.0, -10000.0).astype(np.float32)
    seed = 4321

    def t(x):
        return torch.from_numpy(x)[None, :, None, :]

    o, lse = fa_k.flash_attention_plain(t(q), t(k), t(v), False,
                                        torch.from_numpy(bias)[None], rate,
                                        seed)
    o, lse = o.reshape(T, D).numpy(), lse.reshape(T).numpy()
    keep = (fa_k.dropout_keep_plain(seed, 1, 1, T, T, rate)[0, 0].numpy()
            if rate else None)
    errs = {}
    for name, mm in (('3xTF32', mm3),
                     ('3xTF32 rna', lambda a, b: mm3(a, b, tf32_rna)),
                     ('1xTF32', mm1)):
        got_o, got_lse = forward(mm, q, k, v, bias, keep, rate)
        errs[name] = (float(np.max(np.abs(got_o - o))),
                      float(np.max(np.abs(got_lse - lse))))
    print('rate %.1f, max|err| of O, lse (limit %g): %s' % (
        rate, LIMIT, '; '.join('%s %.2e %.2e' % (k, *v)
                               for k, v in errs.items())))
    assert max(errs['3xTF32']) <= LIMIT
    assert max(errs['3xTF32 rna']) <= LIMIT

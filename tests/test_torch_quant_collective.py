"""The port's quantized all-reduce (K8) against the JAX package's, on
the CPU.

- The plain quantize (``quantize_blocks`` on CPU tensors) against the
  JAX ``quantize_blocks`` in Pallas interpret mode: bitwise, at blocks
  1024, 256, 64, 9 and 8, with row counts that are not powers of two,
  all-zero rows and exact halves (round half to even).
- The plain dequant-reduce-requant against the JAX one in interpret
  mode, n = 2, 3 and 8, blocks 9, 256 and 1024: bitwise.  XLA on the
  CPU compiles the JAX package's ``absmax / 127.0`` into a multiply by
  the f32 reciprocal of 127 and its ``jnp.sum(q * s, axis=0)`` into a
  rank-order chain of fused multiply-adds; the port computes both the
  same way (ROADMAP Queue 3).
- The whole quantized all-reduce over 8 gloo ranks (the world group)
  and 2 (a subgroup of ranks 0 and 1), started by the port's launcher,
  against ``collective_ops._quant_allreduce(v, 'dp', N, block)`` under
  shard_map on an N-device mesh (as tests/test_pallas_kernels.py does):
  bitwise on every rank, at sizes that are not whole blocks, so the
  padding runs.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.compat import shard_map
from paddle_tpu.ops import collective_ops as jcoll
from paddle_tpu.ops.pallas import quant_collective as jqc

import torch

from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import quant_collective as tqc

import torch_dist_cases

# (ranks, payload width, block) of the multi-rank cases; every width
# leaves the last chunk short of whole blocks
ALLREDUCE_CASES = [(8, 1000, 256), (2, 1000, 256), (8, 777, 64),
                   (2, 3001, 64)]


def _payload(n, width, seed):
    x = np.random.RandomState(seed).randn(n, width).astype('float32')
    x[:, 100:150] = 0.0          # all-zero blocks take the s = 1 branch
    x[:, -3:] *= 1e4             # one large block
    return x


_WORKER = torch_dist_cases.PRELUDE + r'''
import json
from paddle_tpu_torch.ops.kernels import common
from paddle_tpu_torch.ops.kernels import quant_collective as qc
cases = json.loads(sys.argv[1])
pair = dist.new_group([0, 1])
out = {}
for i, (n, width, block) in enumerate(cases):
    x = np.random.RandomState(i).randn(n, width).astype('float32')
    x[:, 100:150] = 0.0
    x[:, -3:] *= 1e4
    g = group if n == world else pair
    if rank >= n:
        continue
    y = qc.quant_allreduce(torch.from_numpy(x[rank:rank + 1]), g, n, block)
    assert y.dtype == torch.float32 and tuple(y.shape) == (1, width)
    out[str(i)] = y.numpy().tolist()
assert common.launches('quant_quantize') == 0
np.save(os.path.join(sys.argv[2], 'rank%d.npy' % rank),
        np.array(json.dumps(out)))
'''


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank's result of every case, from one 8-rank launch."""
    tmp = tmp_path_factory.mktemp('quant_allreduce')
    torch_dist_cases.launch(tmp, _WORKER, 8,
                            args=[json.dumps(ALLREDUCE_CASES), str(tmp)])
    return [json.loads(str(np.load(os.path.join(str(tmp), 'rank%d.npy' % r))))
            for r in range(8)]


def _jax_allreduce(x, n, block):
    mesh = Mesh(np.array(jax.devices()[:n]), ('dp',))
    return np.asarray(jax.jit(shard_map(
        lambda v: jcoll._quant_allreduce(v, 'dp', n, block),
        mesh=mesh, in_specs=P('dp'), out_specs=P('dp')))(x))


def _rows(rows, block, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, block) *
         rs.choice([1e-4, 1.0, 300.0], size=(rows, 1))).astype('float32')
    x[1] = 0.0
    # exact halves of the scale: 127 * k / 2 / max for the row maximum
    x[2] = 0.0
    x[2, 0] = 127.0
    x[2, 1:6] = np.arange(1, 6) - 0.5
    return x


@pytest.mark.parametrize('rows,block', [(37, 256), (50, 64), (5, 8),
                                        (11, 9), (6, 1024)])
def test_quantize_plain_is_bitwise_jax(rows, block):
    x = _rows(rows, block, rows)
    jq, js = jqc.quantize_blocks(jnp.asarray(x), True)
    tq, ts = tqc.quantize_blocks(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (rows, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 0].item() == 1.0
    # the halves round to even
    assert tq[2, 1:6].tolist() == [0, 2, 2, 4, 4]


@pytest.mark.parametrize('n', [2, 8])
def test_reduce_plain_is_bitwise_jax(n):
    rs = np.random.RandomState(n)
    cb, block = 45, 256
    q = rs.randint(-127, 128, size=(n, cb, block)).astype('int8')
    s = (rs.rand(n, cb, 1) *
         rs.choice([1e-3, 1.0, 50.0], size=(n, cb, 1))).astype('float32')
    q[:, 3] = 0
    s[:, 3] = 1.0
    jq, js = jqc.dequant_reduce_requant(jnp.asarray(q), jnp.asarray(s), True)
    tq, ts = tqc.dequant_reduce_requant(torch.from_numpy(q),
                                        torch.from_numpy(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize('n,block', [(3, 256), (2, 9), (3, 9), (3, 1024)])
def test_reduce_plain_is_bitwise_jax_at_odd_shapes(n, block):
    """Three ranks, a block whose rows do not start on 16 bytes (9) and
    one longer than the CUDA kernel's 256-element segment (1024), with an
    all-zero row and a row whose absmax is its last element."""
    rs = np.random.RandomState(100 * n + block)
    cb = 13
    q = rs.randint(-127, 128, size=(n, cb, block)).astype('int8')
    s = (rs.rand(n, cb, 1) *
         rs.choice([1e-3, 1.0, 50.0], size=(n, cb, 1))).astype('float32')
    q[:, 3] = 0
    s[:, 3] = 1.0
    q[:, 5] = np.clip(q[:, 5], -100, 100)
    q[:, 5, -1] = 127
    jq, js = jqc.dequant_reduce_requant(jnp.asarray(q), jnp.asarray(s), True)
    tq, ts = tqc.dequant_reduce_requant(torch.from_numpy(q),
                                        torch.from_numpy(s))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[3, 0].item() == 1.0 and not tq[3].any()
    assert tq[5, -1].item() == 127


def test_reduce_is_a_rank_order_fma_chain():
    """Where the separately rounded sum and the fused one differ, the
    port gives the fused one: -3 * 1 + 3 * (1 + 2^-23) is 3 * 2^-23
    exactly, while rounding 3 * (1 + 2^-23) first gives 2^-21."""
    q = np.array([[[-3] * 8], [[3] * 8]], dtype='int8')
    s = np.array([[[1.0]], [[1.0 + 2 ** -23]]], dtype='float32')
    _, ts = tqc.dequant_reduce_requant(torch.from_numpy(q),
                                       torch.from_numpy(s))
    inv127 = np.float32(1) / np.float32(127)
    assert ts.item() == np.float32(3 * 2 ** -23) * inv127
    assert ts.item() != np.float32(2 ** -21) * inv127
    _, js = jqc.dequant_reduce_requant(jnp.asarray(q), jnp.asarray(s), True)
    assert ts.item() == float(np.asarray(js)[0, 0])


def test_cpu_tensors_take_the_plain_versions():
    before = {k: common.launches(k) for k in ('quant_quantize',
                                              'quant_reduce')}
    x = torch.from_numpy(_rows(16, 64, 0))
    q, s = tqc.quantize_blocks(x)
    tqc.dequant_reduce_requant(q.reshape(2, 8, 64), s.reshape(2, 8, 1))
    assert {k: common.launches(k) for k in before} == before
    assert common.KERNELS['quant_quantize']['source'] == \
        'quant_collective.cu'


@pytest.mark.parametrize('case', range(len(ALLREDUCE_CASES)))
def test_allreduce_is_bitwise_the_jax_mesh(ranks, case):
    n, width, block = ALLREDUCE_CASES[case]
    want = _jax_allreduce(_payload(n, width, case), n, block)
    for r in range(n):
        got = np.asarray(ranks[r][str(case)], dtype='float32')
        np.testing.assert_array_equal(got[0], want[r], err_msg='rank %d' % r)


def test_allreduce_is_near_the_exact_sum(ranks):
    """The quantized sum lies within the two quantization steps of the
    f64 sum: sum_r s_r / 2 (each rank's rounding) + s_red / 2 (the
    requantize), by block."""
    n, width, block = ALLREDUCE_CASES[0]
    x = _payload(n, width, 0)
    got = np.asarray(ranks[0]['0'], dtype='float64')[0]
    exact = x.astype('float64').sum(0)
    pad = -(-width // (n * block)) * n * block

    def per_block_scale(v):
        v = np.pad(v, (0, pad - width)).reshape(-1, block)
        return np.repeat(np.abs(v).max(1) / 127.0, block)[:width]

    bound = sum(per_block_scale(x[r]) for r in range(n)) / 2 + \
        per_block_scale(got) / 2
    assert np.all(np.abs(got - exact) <= bound * (1 + 1e-5) + 1e-30)
    assert not np.array_equal(got, exact)

"""Each op lowering of the port's serving slice against the JAX
package's lowering of the same op: the same numpy inputs and attrs go
through both registries.  Outputs agree at atol = rtol = 1e-5 (f32,
other summation orders) or bitwise where the op copies.  The shape
inference of the same cases is held in tests/test_torch_op_shapes.py.
"""

import numpy as np
import pytest

from paddle_tpu_torch.ops import registry as treg

from torch_op_cases import CASES, IDS, run_jax, run_torch


@pytest.mark.parametrize('case', CASES, ids=IDS)
def test_lowering_matches_jax(case):
    _, op, ins, attrs, bitwise = case
    want = run_jax(op, ins, attrs)
    got = run_torch(op, ins, attrs)
    assert got.keys() == want.keys()
    for slot in want:
        assert len(got[slot]) == len(want[slot])
        for g, w in zip(got[slot], want[slot]):
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if bitwise:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_unlowered_op_raises_not_implemented():
    # softmax has a lowering since the image slice, matmul since the
    # attention chain below seq 512; sequence_pool waits for the
    # sequence ops
    with pytest.raises(NotImplementedError, match="'sequence_pool'"):
        treg.get('sequence_pool')

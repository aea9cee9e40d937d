"""word2vec CBOW (models.word2vec: vocabulary 2000, embedding 32, hidden
256, 4 context words sharing one table) in the port against the JAX
package, on the CPU, trained with SGD(1e-3) in f32 at batch 32, as the
upstream book test (python/paddle/fluid/tests/book/test_word2vec.py)
trains it.

The Program serializes as the JAX package's (ops, attributes, vars and
the startup program).  Three steps from the JAX package's startup
values on three seeded batches: the losses within rel 1e-5 and the
parameters (the shared table among them, its gradient summed over the
four lookups) within 1e-6 of their largest magnitude, f32 on both sides
in other summation orders.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import word2vec as jw2v

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import word2vec as tw2v

from torch_image_cases import same_block

VOCAB = 2000
BATCH = 32
LR = 1e-3
STEPS = 3


def _build(fluid, w2v):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, pred, loss = w2v.build(VOCAB)
        fluid.optimizer.SGD(LR).minimize(loss)
    return main, startup, loss, feeds


@pytest.fixture(scope='module')
def progs():
    return {'jax': _build(jfluid, jw2v), 'torch': _build(tfluid, tw2v)}


def test_program_serializes_like_jax(progs):
    for i in (0, 1):
        (jb,) = progs['jax'][i].to_dict()['blocks']
        (tb,) = progs['torch'][i].to_dict()['blocks']
        same_block(jb, tb)
    ops = progs['torch'][0].global_block().ops
    lookups = [op for op in ops if op.type == 'lookup_table']
    assert len(lookups) == 4
    assert {op.input('W')[0] for op in lookups} == {'shared_w'}
    assert sorted(progs['torch'][3]) == ['target', 'word_0', 'word_1',
                                         'word_2', 'word_3']


def test_synthetic_batch_is_the_jax_packages():
    a = tw2v.synthetic_batch(VOCAB, BATCH, np.random.RandomState(4))
    b = jw2v.synthetic_batch(VOCAB, BATCH, np.random.RandomState(4))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == (BATCH, 1) and a[k].dtype == np.int64


def test_three_sgd_steps_match_jax(progs):
    jm, js, jl, _ = progs['jax']
    tm, ts, tl, _ = progs['torch']
    names = weights.startup_names(ts)
    assert 'shared_w' in names
    batches = [tw2v.synthetic_batch(VOCAB, BATCH, np.random.RandomState(i))
               for i in range(STEPS)]
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        state = weights.numpy_state(jfluid.global_scope(), names)
        jloss = [float(np.asarray(jexe.run(jm, feed=b, fetch_list=[jl])[0]))
                 for b in batches]
        jfinal = weights.numpy_state(jfluid.global_scope(), names)
    with tfluid.scope_guard(tfluid.Scope()):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts)
        weights.load_numpy_params(tfluid.global_scope(), state,
                                  tfluid.CPUPlace(), ts)
        tloss = [float(texe.run(tm, feed=b, fetch_list=[tl])[0])
                 for b in batches]
        tfinal = weights.numpy_state(tfluid.global_scope(), names)
    assert all(np.isfinite(tloss))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    moved = 0
    for n in names:
        np.testing.assert_allclose(
            tfinal[n], jfinal[n], rtol=0,
            atol=1e-6 * float(np.abs(jfinal[n]).max()), err_msg=n)
        moved += not np.array_equal(tfinal[n], state[n])
    assert moved == 5  # the table and the two fc layers' weights and biases

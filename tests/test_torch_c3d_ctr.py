"""The slice's two card programs, cut to a few layers and narrow widths,
against the JAX package on the CPU, built by chip_smoke.py's own
program functions (c3d_build, ctr_build, two_loss_build, which take
either package's `fluid`): each program must serialize alike in both packages
(same_program, main and startup), then both train from the JAX
package's startup state on the same numpy batches (run_both).

C3D-tiny is two conv3d blocks on 3 x 4 x 16 x 16 clips (the second
pool padded (0, 1, 1), as C3D's pool5), dropout off; CTR-tiny is 2
slots hashed twice into a 1,001-row table with data_norm and the CVM.
Tolerances: per-step losses within rel LOSS_RTOL = 1e-4 over free-run
steps; the CTR-DNN's auc statistics bitwise, its AUC and data_norm's
parameters (the layer's statistics, which Adagrad updates as
parameters in both packages) within STATE_TOL = 1e-4 of their largest
magnitude after every step.  The two-loss oracle (the JAX package's
tests/test_wpg_default.py::test_multi_loss_takes_wpg_and_matches_per_op)
holds the port's whole-program grad with 2 seeds against its per-op
grad path within rtol 1e-5 / atol 1e-6.
"""

import contextlib
import importlib.util
import os

import numpy as np

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor

from torch_attention_cases import close
from torch_program_cases import build_both, run_both, same_program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
STATE_TOL = 1e-4
C3D_TINY = {'widths': ((4,), (8,)), 'pools': ((1, 2, 2), (2, 2, 2)),
            'pads': ((0, 0, 0), (0, 1, 1)), 'clip': (4, 16, 16), 'fc': 32,
            'classes': 10, 'dropout': 0.0}
CTR_TINY = {'dense': 13, 'slots': 2, 'rows': 1001, 'emb': 4, 'num_hash': 2,
            'hidden': (16, 8), 'thresholds': 255}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _same(progs):
    same_program(progs['jax'][0], progs['torch'][0])
    same_program(progs['jax'][1], progs['torch'][1])


def _losses_close(out, k=0):
    want = [float(np.asarray(r[k]).ravel()[0]) for r in out['jax']]
    got = [float(np.asarray(r[k]).ravel()[0]) for r in out['torch']]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    return want


def test_c3d_tiny_trains_like_jax():
    def build(fluid):
        feeds, logits, loss = CS.c3d_build(fluid, C3D_TINY)
        fluid.optimizer.SGD(0.05).minimize(loss)
        return [loss, logits]
    progs = build_both(build)
    _same(progs)
    types = [op.type for op in progs['torch'][0].global_block().ops]
    assert types.count('conv3d') == 2 and types.count('pool3d') == 2
    assert 'conv3d_grad' in types and 'pool3d_grad' in types
    pool = [v for v in progs['torch'][0].global_block().vars.values()
            if v.op is not None and v.op.type == 'pool3d']
    assert tuple(pool[-1].shape) == (-1, 8, 2, 5, 5)
    rng = np.random.RandomState(3)
    feeds = [{'clip': rng.randn(4, 3, 4, 16, 16).astype('float32'),
              'label': rng.randint(0, 10, (4, 1)).astype('int64')}
             for _ in range(5)]
    out = run_both(progs, feeds)
    losses = _losses_close(out)
    for jr, tr in zip(out['jax'], out['torch']):
        close(tr[1], jr[1], STATE_TOL)
    assert losses[-1] != losses[0]


def _ctr_build(cvm_layer):
    def build(fluid):
        feeds, predict, loss, auc, stats = CS.ctr_build(fluid, CTR_TINY,
                                                        cvm_layer)
        fluid.optimizer.Adagrad(1e-2, epsilon=1e-6).minimize(loss)
        norm = sorted(p.name for p in fluid.default_main_program()
                      .all_parameters() if p.name.startswith('data_norm'))
        return [loss, auc, predict] + list(stats) + norm
    return build


def test_ctr_tiny_trains_like_jax_with_data_norm_and_the_cvm():
    """Against the JAX package through the cvm layer (its
    continuous_value_model layer's program has no value for its
    output); the port's continuous_value_model program, the card's,
    gives bitwise the same steps."""
    progs = build_both(_ctr_build('cvm'))
    _same(progs)
    types = [op.type for op in progs['torch'][0].global_block().ops]
    for t in ('hash', 'data_norm', 'cvm', 'fused_emb_update', 'auc'):
        assert t in types, t
    assert 'lookup_table_grad' not in types
    rng = np.random.RandomState(4)
    feeds = [CS.ctr_batch(CTR_TINY, 64, rng) for _ in range(6)]
    out = run_both(progs, feeds)
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        fetch = _ctr_build('continuous_value_model')(tfluid)
    assert 'continuous_value_model' in [op.type for op in
                                        main.global_block().ops]
    # from the same JAX startup state
    port = run_both({'jax': progs['jax'], 'torch': (main, startup, fetch)},
                    feeds)['torch']
    for a, b in zip(port, out['torch']):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    losses = _losses_close(out)
    assert losses[-1] < losses[0]
    for jr, tr in zip(out['jax'], out['torch']):
        close(tr[1], jr[1], STATE_TOL, 'auc')
        close(tr[2], jr[2], STATE_TOL, 'predict')
        for k in (3, 4):   # StatPos, StatNeg: whole counts
            np.testing.assert_array_equal(tr[k], jr[k])
        for k in range(5, 8):   # data_norm's BatchSize / Sum / SquareSum
            close(tr[k], jr[k], STATE_TOL, 'data_norm')
    assert not np.array_equal(out['torch'][-1][5], out['torch'][0][5])


def _two_loss_program(fluid, seed=5):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss, aux = CS.two_loss_build(fluid)
    return main, startup, loss, aux


def _two_loss_train(feeds, per_op):
    main, startup, loss, aux = _two_loss_program(tfluid)
    with tfluid.scope_guard(tfluid.Scope()), (
            CS.per_op_grads() if per_op else contextlib.nullcontext()):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        plan = exe._get_plan(main, feeds[0], [loss.name, aux.name])
        losses = [[float(v) for v in exe.run(main, feed=f,
                                             fetch_list=[loss, aux])]
                  for f in feeds]
        params = {p.name: np.asarray(tfluid.global_scope().find_var(p.name))
                  for p in main.all_parameters()}
    return plan, np.array(losses), params


def test_two_losses_take_the_whole_program_grad_and_match_per_op():
    main, _, loss, aux = _two_loss_program(tfluid)
    part = texecutor._wpg_partition(main.global_block().ops, main,
                                    [loss.name])
    assert part is not None and len(part['seeds']) == 2
    assert set(part['regions'].values()) == {1}   # the last walk's grads
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(6):
        xb = rng.randn(16, 256).astype('float32')
        feeds.append({'x': xb, 'y': xb[:, :8].sum(1, keepdims=True)})
    plan, got, got_p = _two_loss_train(feeds, per_op=False)
    assert plan.kind == 'wpg' and len(plan.wpg['seeds']) == 2
    plan, want, want_p = _two_loss_train(feeds, per_op=True)
    assert plan.kind == 'per_op'
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for n in want_p:
        np.testing.assert_allclose(got_p[n], want_p[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
    # and the JAX package's losses from the same startup state
    progs = build_both(lambda fluid: list(CS.two_loss_build(fluid)), seed=5)
    _same(progs)
    out = run_both(progs, feeds)
    for k in (0, 1):
        _losses_close(out, k)


def test_a_recompute_program_keeps_its_single_seed_rule():
    """Two losses and a recompute span: the per-op grad path, as any
    plan the whole-program grad cannot take."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[8], dtype='float32')
        h = fluid.layers.fc(x, 16, act='relu')
        h2 = fluid.layers.fc(h, 16, act='relu')
        loss = fluid.layers.mean(fluid.layers.fc(h2, 1))
        aux = fluid.layers.mean(fluid.layers.abs(h2))
        fluid.backward.append_backward(loss, checkpoints=[h])
        fluid.backward.append_backward(aux)
    ops = main.global_block().ops
    assert texecutor._wpg_partition(ops, main, [loss.name]) is None


def test_scaled_dot_product_attention_like_jax():
    def build(fluid):
        L = fluid.layers
        q = L.data('q', [5, 16], dtype='float32')
        k = L.data('k', [7, 16], dtype='float32')
        v = L.data('v', [7, 16], dtype='float32')
        for var in (q, k, v):
            var.stop_gradient = False
        out = fluid.nets.scaled_dot_product_attention(q, k, v, num_heads=4)
        return [out] + fluid.gradients(L.reduce_sum(L.square(out)), [q, k, v])
    progs = build_both(build)
    _same(progs)
    rng = np.random.RandomState(6)
    feeds = [{n: rng.randn(3, t, 16).astype('float32')
              for n, t in (('q', 5), ('k', 7), ('v', 7))}]
    out = run_both(progs, feeds)
    for g, w in zip(out['torch'][0], out['jax'][0]):
        close(g, w, 1e-5)

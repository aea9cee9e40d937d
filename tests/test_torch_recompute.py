"""RecomputeOptimizer and append_backward(checkpoints=...) in the port
(fluid/backward.py _RecomputePlan, fluid/executor.py recompute spans)
on the CPU, the counterparts of the JAX package's
tests/test_recompute.py and more:

- the rewritten program serializes as the JAX package's: the same
  recompute_barrier ops, the same @RC / @RCIN names and the backward
  role on the re-emitted ops (an MLP, and BERT-tiny checkpointed at its
  encoder layers' outputs);
- training with recompute equals training without it, bitwise, on the
  whole-program grad (each span's forward under non-reentrant
  torch.utils.checkpoint, the dropout masks drawn again bit for bit),
  and the JAX package's recompute training within rtol 1e-5;
- the per-op grad path (taken where a fetch reads an intermediate's
  gradient) runs the re-emitted ops as written, with the same
  gradients as the whole-program grad (within 1e-6);
- under the spans autograd keeps fewer bytes for the backward;
- the fleet's DistributedStrategy.use_recompute builds the same
  program as RecomputeOptimizer;
- the eval clone prunes the recompute ops, as the JAX package's.
"""

import numpy as np
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid.incubate.fleet.collective import (
    CollectiveOptimizer, DistributedStrategy)
from paddle_tpu_torch.models import bert as tbert

from torch_program_cases import assert_runs_close, run_both, same_program

TOL = 1e-5


def _mlp(fluid, recompute, seed=7, via_fleet=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data('x', shape=[16], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='float32')
        h1 = fluid.layers.fc(x, 32, act='relu')
        h2 = fluid.layers.fc(h1, 32, act='relu')
        h3 = fluid.layers.fc(h2, 32, act='relu')
        pred = fluid.layers.fc(h3, 1)
        d = pred - y
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
        opt = fluid.optimizer.SGD(0.05)
        if via_fleet:
            s = DistributedStrategy()
            s.use_recompute = True
            s.recompute_checkpoints = [h2]
            CollectiveOptimizer(opt, s).minimize(loss)
        elif recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h2])
            opt.minimize(loss)
        else:
            opt.minimize(loss)
    return main, startup, loss, h1


def _feeds(n=8):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        xb = rng.randn(16, 16).astype('float32')
        out.append({'x': xb, 'y': xb.sum(1, keepdims=True)})
    return out


def _bert_cfg(mod):
    return mod.BertConfig(vocab_size=300, hidden=32, layers=3, heads=2,
                          intermediate=64, max_pos=32, dropout=0.1,
                          attn_dropout=0.1)


def _encoder_outputs(main):
    lns = [op for op in main.global_block().ops if op.type == 'layer_norm']
    return [op.output('Y')[0] for op in lns[2::2]]


def _bert(fluid, mod, recompute):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = mod.build_pretrain(_bert_cfg(mod), seq_len=16)
        opt = fluid.optimizer.Adam(learning_rate=1e-3)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(_encoder_outputs(main))
        opt.minimize(loss)
    return main, startup, loss


def _bert_feed():
    return tbert.synthetic_batch(_bert_cfg(tbert), 2, 16,
                                 np.random.RandomState(0))


def test_rewrite_serializes_like_jax():
    for build in (lambda f, m: _mlp(f, True)[0],
                  lambda f, m: _bert(f, m, True)[0]):
        jm, tm = build(jfluid, jbert), build(tfluid, tbert)
        same_program(jm, tm)
        ops = tm.global_block().ops
        barriers = [op for op in ops if op.type == 'recompute_barrier']
        assert barriers and all(
            op.attrs['__op_role__'] == 'backward' and
            op.output('Out')[0].endswith('@RCIN') for op in barriers)
        twins = [op for op in ops if op.output_arg_names and all(
            n.endswith('@RC') for n in op.output_arg_names)]
        assert twins and all(op.attrs['__op_role__'] == 'backward'
                             for op in twins)


def _train_torch(main, startup, loss, feeds, fetch_extra=()):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        plan = exe._get_plan(main, feeds[0], [loss.name] + list(fetch_extra))
        outs = [exe.run(main, feed=f, fetch_list=[loss] + list(fetch_extra),
                        return_numpy=False) for f in feeds]
        state = {n: scope.find_var(n).clone()
                 for n in weights.startup_names(startup)}
    return plan, outs, state


def test_mlp_recompute_bitwise_plain_and_close_to_jax():
    feeds = _feeds()
    _, plain, p_state = _train_torch(*_mlp(tfluid, False)[:3], feeds)
    plan, rc, r_state = _train_torch(*_mlp(tfluid, True)[:3], feeds)
    assert plan.kind == 'wpg' and plan.spans
    for a, b in zip(plain, rc):
        assert torch.equal(a[0], b[0])
    assert all(torch.equal(p_state[n], r_state[n]) for n in p_state)
    # from the JAX package's startup state, both packages' recompute runs
    progs = {}
    for key, fluid in (('jax', jfluid), ('torch', tfluid)):
        main, startup, loss, _ = _mlp(fluid, True)
        progs[key] = (main, startup, [loss])
    assert_runs_close(run_both(progs, feeds), TOL)


def test_bert_recompute_steps_bitwise_plain():
    feed = _bert_feed()
    _, plain, p_state = _train_torch(*_bert(tfluid, tbert, False), [feed] * 3)
    plan, rc, r_state = _train_torch(*_bert(tfluid, tbert, True), [feed] * 3)
    assert plan.kind == 'wpg'
    assert len(plan.spans) == _bert_cfg(tbert).layers + 1
    assert [float(o[0]) for o in plain] == [float(o[0]) for o in rc]
    assert all(torch.equal(p_state[n], r_state[n]) for n in p_state)


def test_per_op_path_runs_the_recompute_program():
    """Fetching h1's gradient takes the per-op grad path, which runs the
    barriers and the re-emitted span as written."""
    feeds = _feeds(3)
    main, startup, loss, h1 = _mlp(tfluid, True)
    g_h1 = main._grad_name_map[h1.name]
    plan, per_op, state = _train_torch(main, startup, loss, feeds, [g_h1])
    assert plan.kind == 'per_op'
    ran = [st.op.type for step in plan.steps for st in step.members]
    assert 'recompute_barrier' in ran
    _, wpg, wpg_state = _train_torch(*_mlp(tfluid, True)[:3], feeds)
    for a, b in zip(per_op, wpg):
        np.testing.assert_allclose(a[0].numpy(), b[0].numpy(), rtol=1e-6)
    for n in state:
        np.testing.assert_allclose(state[n].numpy(), wpg_state[n].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_spans_keep_fewer_bytes_for_the_backward():
    feed = _bert_feed()
    kept = {}
    for rc in (False, True):
        main, startup, loss = _bert(tfluid, tbert, rc)
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            total = [0]

            def pack(t):
                total[0] += t.numel() * t.element_size()
                return t
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                exe.run(main, feed=feed, fetch_list=[loss])
        kept[rc] = total[0]
    assert kept[True] < kept[False] / 2, kept


def test_fleet_use_recompute_builds_the_recompute_program():
    fm, fs, floss, _ = _mlp(tfluid, True, via_fleet=True)
    rm = _mlp(tfluid, True)[0]
    f_types = [op.type for op in fm.global_block().ops
               if not op.type.startswith('c_') and op.type != 'scale']
    r_types = [op.type for op in rm.global_block().ops]
    assert f_types == r_types
    assert fm._collective_dp
    _, outs, _ = _train_torch(fm, fs, floss, _feeds(2))
    assert all(np.isfinite(float(o[0])) for o in outs)


def test_eval_clone_prunes_recompute_ops_like_jax():
    jt = _mlp(jfluid, True)[0].clone(for_test=True)
    tt = _mlp(tfluid, True)[0].clone(for_test=True)
    same_program(jt, tt)
    for op in tt.global_block().ops:
        assert op.type != 'recompute_barrier'
        assert not any(n.endswith('@RC') for n in op.output_arg_names)

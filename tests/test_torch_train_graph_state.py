"""The state a training step writes, in place (fluid/executor.py
``_write_state``), on the CPU: the port's counterpart of the JAX
package's donated state, which a CUDA graph of the step needs.

- every startup variable of a small BERT (hidden and attention dropout
  0.1, Adam), of the same BERT under AMP (the loss scale and its
  counters), of LeNet-5 (Adam) and of an fc net under LAMB with the
  warmup-over-decay schedule (the learning-rate counter) is the same
  tensor object after each of 3 steps, and the values move as the
  optimizer says (beta powers 0.9 ** k, 3 good AMP steps, the counter
  at 3);
- a persistable fetched with return_numpy=False does not change under
  the next step;
- the small BERT (attention dropout 0.1, hidden dropout 0, whose masks
  are threefry in the JAX package) and the tiny Transformer (dropout 0)
  take 3 steps in place from the JAX package's startup state and hold
  its losses (rel 1e-5) and parameters (1e-5), the tolerances of
  tests/test_torch_train_parity.py and tests/test_torch_transformer.py;
- the plans of these steps may be captured in a CUDA graph, a
  training batch norm's too (its running statistics written in place),
  and a startup program (host-drawn initializers) never is, with its
  reason;
- ``common.upload`` during a capture gives a buffer of its own and
  keeps a copy of the host values for its capturer;
- ``fluid.transpiler.memory_optimize`` and ``release_memory`` are the
  JAX package's no-ops.
"""

import numpy as np

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import transformer as jtr

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import weights
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.kernels import common

SEQ = 32
STEPS = 3


def _bert_cfg(mod, dropout=0.1):
    cfg = mod.BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                         intermediate=128, max_pos=SEQ, dropout=dropout,
                         attn_dropout=0.1)
    cfg.flash_min_len = 0
    return cfg


def _bert(fluid, mod, amp=False, dropout=0.1):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = mod.build_pretrain(_bert_cfg(mod, dropout), seq_len=SEQ)
        opt = fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, use_dynamic_loss_scaling=True)
        opt.minimize(loss)
    return main, startup, loss


def _bert_batch():
    return tbert.synthetic_batch(_bert_cfg(tbert), 2, SEQ,
                                 np.random.RandomState(0))


def _lenet():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        _, _, loss, _ = tlenet.build()
        tfluid.optimizer.Adam(1e-3).minimize(loss)
    imgs, labels = mnist._synthetic(8, 0)
    return main, startup, loss, {'img': imgs.reshape(-1, 1, 28, 28),
                                 'label': labels.reshape(-1, 1)}


def _lamb_fc():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[6], dtype='float32')
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 4))
        lr = tfluid.layers.linear_lr_warmup(
            tfluid.layers.polynomial_decay(1e-3, 100, 0.0), 2, 0.0, 1e-3)
        tfluid.optimizer.Lamb(lr).minimize(loss)
    return main, startup, loss, {'x': np.ones((4, 6), 'float32')}


def _steps_in_place(main, startup, loss, feed):
    """3 CPU steps; asserts every startup variable stays the same tensor
    object.  Returns (start values, end values, losses)."""
    names = weights.startup_names(startup)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        held = {n: scope.find_var(n) for n in names}
        start = {n: v.clone() for n, v in held.items()}
        losses = []
        for _ in range(STEPS):
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]))
            for n, v in held.items():
                assert scope.find_var(n) is v, n
    return start, {n: v.clone() for n, v in held.items()}, losses


def _params_moved(main, start, end):
    for p in main.all_parameters():
        assert not torch.equal(start[p.name], end[p.name]), p.name


def test_bert_state_stays_in_its_tensors():
    main, startup, loss = _bert(tfluid, tbert)
    start, end, losses = _steps_in_place(main, startup, loss, _bert_batch())
    assert all(np.isfinite(losses))
    _params_moved(main, start, end)
    pows = [n for n in end if '_beta1_pow_acc_' in n]
    assert pows
    for n in pows:
        assert torch.allclose(end[n], torch.full_like(end[n], 0.9 ** 3))


def test_amp_bert_state_stays_in_its_tensors():
    main, startup, loss = _bert(tfluid, tbert, amp=True)
    start, end, losses = _steps_in_place(main, startup, loss, _bert_batch())
    assert all(np.isfinite(losses))
    _params_moved(main, start, end)
    assert end['good_steps_0'].tolist() == [STEPS]
    assert end['bad_steps_0'].tolist() == [0]
    assert torch.equal(end['loss_scaling_0'], start['loss_scaling_0'])


def test_lenet_state_stays_in_its_tensors():
    main, startup, loss, feed = _lenet()
    start, end, losses = _steps_in_place(main, startup, loss, feed)
    assert losses[-1] < losses[0]
    _params_moved(main, start, end)


def test_lr_counter_stays_in_its_tensor():
    main, startup, loss, feed = _lamb_fc()
    start, end, _ = _steps_in_place(main, startup, loss, feed)
    (counter,) = [n for n in end if 'LR_DECAY_COUNTER' in n]
    assert float(end[counter]) == float(start[counter]) + STEPS


def test_a_fetched_persistable_does_not_follow_the_next_step():
    main, startup, loss, feed = _lenet()
    name = sorted(p.name for p in main.all_parameters())[0]
    moment = [n for n in weights.startup_names(startup)
              if n.startswith(name + '_moment1_')][0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        got = exe.run(main, feed=feed, fetch_list=[loss, name, moment],
                      return_numpy=False)
        kept = [t.clone() for t in got[1:]]
        exe.run(main, feed=feed, fetch_list=[loss])
        scope = tfluid.global_scope()
        for t, k, n in zip(got[1:], kept, (name, moment)):
            assert torch.equal(t, k)
            assert t is not scope.find_var(n)
            assert not torch.equal(scope.find_var(n), k)


def _jax_state_and_losses(jprogs, tstartup, feeds):
    jmain, jstartup, jloss = jprogs
    names = weights.startup_names(tstartup)
    with jfluid.scope_guard(jfluid.Scope()):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        state = weights.numpy_state(jfluid.global_scope(), names)
        losses = [float(np.asarray(jexe.run(jmain, feed=f,
                                            fetch_list=[jloss])[0]))
                  for f in feeds]
        final = weights.numpy_state(jfluid.global_scope(), names)
    return state, losses, final


def _port_in_place(tprogs, state, feeds):
    tmain, tstartup, tloss = tprogs
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(tstartup)
        weights.load_numpy_params(scope, state, tfluid.CPUPlace(), tstartup)
        held = {n: scope.find_var(n) for n in state}
        losses = []
        for f in feeds:
            losses.append(float(exe.run(tmain, feed=f,
                                        fetch_list=[tloss])[0]))
            assert all(scope.find_var(n) is v for n, v in held.items())
        return losses, {n: v.numpy().copy() for n, v in held.items()}


def _hold_jax(jprogs, tprogs, feeds):
    state, jlosses, jfinal = _jax_state_and_losses(jprogs, tprogs[1], feeds)
    tlosses, tfinal = _port_in_place(tprogs, state, feeds)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    params = [p.name for p in tprogs[0].all_parameters()]
    for n in params:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=0, atol=1e-5,
                                   err_msg=n)
        assert not np.array_equal(tfinal[n], state[n]), n


def test_bert_steps_in_place_hold_the_jax_package():
    feeds = [_bert_batch()] * STEPS
    _hold_jax(_bert(jfluid, jbert, dropout=0.0),
              _bert(tfluid, tbert, dropout=0.0), feeds)


def _nmt_cfg(mod):
    return mod.TransformerConfig(src_vocab=500, tgt_vocab=500, d_model=64,
                                 heads=4, ffn=128, enc_layers=2,
                                 dec_layers=2, dropout=0.0, max_len=64)


def _nmt(fluid, mod):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = mod.build(_nmt_cfg(mod), src_len=16, tgt_len=16,
                               label_smooth_eps=0.1)
        fluid.optimizer.Adam(learning_rate=1e-3, epsilon=1e-6).minimize(loss)
    return main, startup, loss


def test_transformer_steps_in_place_hold_the_jax_package():
    rng = np.random.RandomState(0)
    feeds = [ttr.synthetic_batch(_nmt_cfg(ttr), 4, 16, 16, rng)
             for _ in range(STEPS)]
    _hold_jax(_nmt(jfluid, jtr), _nmt(tfluid, ttr), feeds)


def _plan(program, fetch):
    exe = tfluid.Executor(tfluid.CPUPlace())
    return exe._get_plan(program, {}, [fetch.name if hasattr(fetch, 'name')
                                       else fetch])


def test_training_plans_may_be_captured_and_startup_not():
    for main, startup, loss in (_bert(tfluid, tbert),
                                _bert(tfluid, tbert, amp=True),
                                _nmt(tfluid, ttr), _lenet()[:3]):
        plan = _plan(main, loss)
        assert plan.kind == 'wpg' and plan.no_graph is None
        why = _plan(startup, loss).no_graph
        assert 'host generator' in why and 'random' in why


def test_a_training_batch_norm_keeps_its_statistics_in_place():
    """A batch norm's running statistics are state like the rest: the
    step writes them into their tensors, and its plan may be
    captured."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 2
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data('x', shape=[3, 4, 4], dtype='float32')
        y = tfluid.layers.batch_norm(tfluid.layers.conv2d(x, 2, 3))
        loss = tfluid.layers.mean(y)
        tfluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    assert _plan(main, loss).no_graph is None
    feed = {'x': np.random.RandomState(0).rand(4, 3, 4, 4).astype(
        'float32')}
    start, end, _ = _steps_in_place(main, startup, loss, feed)
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    assert len(stats) == 2
    for n in stats:
        assert not torch.equal(start[n], end[n]), n


def test_upload_in_a_capture_takes_a_buffer_of_its_own():
    """Inside a capture each upload gets a buffer of its own, which the
    capturer fills from the host values the recording keeps."""
    table = np.arange(12, dtype=np.int64).reshape(3, 4)
    assert common.recording() is None
    with common.recording_launches() as rec:
        assert common.recording() is rec
        buf = common.upload(table, 'cpu')
        common.count_launch('fused_adam')
        other = common.upload(table[:1], 'cpu')
    assert common.recording() is None
    (got, host), (got1, _) = rec.uploads
    assert got is buf and got1 is other
    assert buf.shape == (3, 4) and buf.dtype == torch.int64
    assert buf.data_ptr() != other.data_ptr()
    table[0, 0] = 99  # the capture keeps its own copy of the host values
    assert host[0, 0] == 0
    for b, h in rec.uploads:
        b.copy_(torch.from_numpy(h))
    assert buf.tolist() == np.arange(12).reshape(3, 4).tolist()
    assert rec.launches == {'fused_adam': 1}


def test_memory_optimize_is_the_jax_packages_no_op():
    from paddle_tpu.fluid import transpiler as jtranspiler
    main, startup, loss, feed = _lenet()
    before = main.to_dict()
    for mod in (tfluid.transpiler, jtranspiler):
        assert mod.memory_optimize(main, skip_opt_set={loss.name},
                                   print_log=True, level=1) is None
        assert mod.release_memory(main) is None
    assert main.to_dict() == before

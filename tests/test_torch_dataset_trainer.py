"""The port's Dataset plane (paddle_tpu_torch/runtime, fluid/dataset.py,
fluid/trainer_desc.py, fluid/device_worker.py and
Executor.train_from_dataset / infer_from_dataset) against the JAX
package's, on the CPU.

- The native MultiSlot feeder, built here by g++ from the port's own
  datafeed.cc: at one thread its batches are bitwise the JAX feeder's
  (the same order, the partial last batch included, with and without
  the reader's shuffle buffer, whose std::mt19937_64 both libraries
  seed alike); at 3 threads the rows are the same multiset.
- InMemoryDataset: load_into_memory, local_shuffle (numpy's
  RandomState(seed) over the batches) and the memory size as the JAX
  package's; QueueDataset's batches as the JAX package's.
- train_from_dataset on wide_deep.TINY from the JAX package's startup
  state: the losses (rtol 1e-5) and the final parameters (atol 1e-5)
  and moments (atol 1e-6) at the Wide&Deep parity test's tolerances
  (tests/test_torch_wide_deep.py; the JAX side runs its row update as
  the Pallas kernel in interpret mode); through thread=2's staging
  iterator bitwise its thread=1 run, and bitwise exe.run over the same
  batches.
- infer_from_dataset updates nothing and makes its inference clone
  again after the program changes; DataLoader.from_dataset drops a
  short last batch; the TrainerFactory surface is the JAX package's.
"""

import collections
import os
import threading

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU, as the conftest pins it)

import paddle_tpu.fluid as jfluid
from paddle_tpu import runtime as jruntime
from paddle_tpu.fluid.flags import _DEFAULTS as J_DEFAULTS
from paddle_tpu.fluid.flags import set_flags as j_set_flags
from paddle_tpu.models import wide_deep as jwd

import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import runtime as truntime
from paddle_tpu_torch import weights
from paddle_tpu_torch.fluid import flags as tflags
from paddle_tpu_torch.models import wide_deep as twd

CFG = twd.TINY
BATCH = 16
SLOTS = [('dense_input', 'dense', CFG.num_dense_fields),
         ('sparse_input', 'sparse', CFG.num_sparse_fields),
         ('label', 'sparse', 1)]


def _write_files(d, rows=(23, 21), seed=0, ragged=False):
    """MultiSlot text in Criteo's layout at TINY's widths: the dense
    fields, the hashed ids, the label."""
    rng = np.random.RandomState(seed)
    paths = []
    for k, n in enumerate(rows):
        path = os.path.join(str(d), 'part-%d' % k)
        with open(path, 'w') as f:
            for _ in range(n):
                dense = rng.rand(CFG.num_dense_fields).astype('float32')
                nids = rng.randint(1, CFG.num_sparse_fields + 1) if ragged \
                    else CFG.num_sparse_fields
                ids = rng.randint(0, CFG.sparse_feature_dim, nids)
                f.write('%d %s %d %s 1 %d\n' % (
                    len(dense), ' '.join('%.9g' % v for v in dense),
                    nids, ' '.join(str(i) for i in ids),
                    int(dense.sum() > 2)))
        paths.append(path)
    return paths


def _np_batches(batches):
    return [{k: np.asarray(v) for k, v in b.items()} for b in batches]


def _same_batches(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        assert t.keys() == j.keys()
        for k in t:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            assert np.array_equal(t[k].view(np.uint8), j[k].view(np.uint8))


@pytest.mark.parametrize('shuffle_buffer', [0, 8])
def test_feeder_at_one_thread_is_the_jax_feeders_bitwise(tmp_path,
                                                         shuffle_buffer):
    files = _write_files(tmp_path, ragged=True)
    got = []
    for mod in (jruntime, truntime):
        feed = mod.MultiSlotDataFeed(files, SLOTS, BATCH, 1,
                                     shuffle_buffer, 5)
        got.append(_np_batches(feed))
        feed.close()
    assert [len(b['label']) for b in got[1]] == [16, 16, 12]
    _same_batches(got[1], got[0])
    assert (got[1][0]['sparse_input'] == -1).any()  # ragged ids padded


def test_feeder_at_three_threads_gives_the_same_rows(tmp_path):
    files = _write_files(tmp_path, rows=(40, 7, 33))
    rows = []
    for mod, n in ((jruntime, 1), (truntime, 3)):
        feed = mod.MultiSlotDataFeed(files, SLOTS, BATCH, n)
        rows.append(collections.Counter(
            tuple(np.concatenate([b[name][r].astype('float64').ravel()
                                  for name, _, _ in SLOTS]))
            for b in _np_batches(feed) for r in range(len(b['label']))))
        feed.close()
    assert rows[0] == rows[1] and sum(rows[1].values()) == 80


def test_feeder_builds_once_into_the_build_dir(tmp_path):
    saved = tflags.get_flags(['FLAGS_torch_runtime_build_dir'])
    tflags.set_flags({'FLAGS_torch_runtime_build_dir': str(tmp_path)})
    try:
        paths, errors = [], []

        def build():
            try:
                paths.append(truntime.build())
            except Exception as e:  # reported below
                errors.append(e)
        threads = [threading.Thread(target=build) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert errors == [] and len(paths) == 3
        assert len(set(paths)) == 1 and os.path.exists(paths[0])
        assert os.listdir(str(tmp_path)) == [os.path.basename(paths[0])]
        assert paths[0] == truntime.library_path()
    finally:
        tflags.set_flags(saved)


def _use_vars(fluid, wd):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        feeds, _, _ = wd.build(CFG)
    return [feeds[n] for n, _, _ in SLOTS]


def _dataset(fluid, wd, files, kind, thread=1):
    ds = fluid.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(BATCH)
    ds.set_thread(thread)
    ds.set_filelist(files)
    ds.set_use_var(_use_vars(fluid, wd))
    ds.seed = 3
    return ds


def test_in_memory_shuffle_and_queue_batches_are_the_jax_packages(
        tmp_path):
    files = _write_files(tmp_path, rows=(50, 30))
    got = {}
    for fluid, wd in ((jfluid, jwd), (tfluid, twd)):
        mem = _dataset(fluid, wd, files, 'InMemoryDataset')
        mem.load_into_memory()
        assert mem.get_memory_data_size() == 80
        mem.local_shuffle()
        queue = _dataset(fluid, wd, files, 'QueueDataset')
        got[fluid] = (_np_batches(mem.batches()),
                      _np_batches(queue.batches()))
        mem.release_memory()
        assert mem.get_memory_data_size() == 0
    for t, j in zip(got[tfluid], got[jfluid]):
        for tb, jb in zip(t, j):  # int64 columns: int32 in the JAX package
            for k in tb:
                if tb[k].dtype == np.int64:
                    jb[k] = jb[k].astype(np.int64)
        _same_batches(t, j)
    order = [int(b['label'].shape[0]) for b in got[tfluid][0]]
    assert sorted(order) == [16] * 5
    assert not all(np.array_equal(a['dense_input'], b['dense_input'])
                   for a, b in zip(*got[tfluid]))  # shuffled
    assert got[tfluid][1][0]['dense_input'].shape == (16, 4)
    assert got[tfluid][1][0]['label'].shape == (16, 1)


def _restore_jax_flags():
    j_set_flags({k: v for k, v in J_DEFAULTS.items()
                 if k.startswith('FLAGS_pallas_')})


def _wd_program(fluid, wd):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _, preds, loss = wd.build(CFG)
        fluid.optimizer.Adagrad(0.05, epsilon=1e-6).minimize(loss)
    return main, startup, loss, preds


def _record_fetches(exe, into):
    """Record the first fetch of each exe.run that train_from_dataset /
    infer_from_dataset makes (print_period=1 fetches every step)."""
    run = exe.run

    def recorded(*args, **kwargs):
        out = run(*args, **kwargs)
        if out:
            into.append(out[0])
        return out
    exe.run = recorded


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    files = _write_files(tmp_path_factory.mktemp('wd'), rows=(40, 30))
    jmain, jstart, jloss, _ = _wd_program(jfluid, jwd)
    tmain, tstart, tloss, _ = _wd_program(tfluid, twd)
    names = weights.startup_names(tstart)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    j_set_flags({'FLAGS_pallas_force': True,
                 'FLAGS_pallas_embedding_min_rows': 1})
    try:
        with jfluid.scope_guard(jscope):
            jexe.run(jstart)
            state = {n: np.asarray(jscope.find_var(n)) for n in names}
            ds = _dataset(jfluid, jwd, files, 'InMemoryDataset')
            ds.load_into_memory()
            jbatches = _np_batches(ds.batches())
            jexe.train_from_dataset(jmain, ds)
            jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
            # the JAX package's losses on the same batches, same steps
            jscope2 = jfluid.Scope()
            with jfluid.scope_guard(jscope2):
                jexe.run(jstart)
                for n, v in state.items():
                    jscope2.set_var(n, v)
                jlosses = [float(np.asarray(jexe.run(
                    jmain, feed=b, fetch_list=[jloss])[0]))
                    for b in jbatches]
    finally:
        _restore_jax_flags()
    runs = {}
    for thread in (1, 2):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        losses = []
        with tfluid.scope_guard(scope):
            exe.run(tstart)
            weights.load_numpy_params(scope, state, tfluid.CPUPlace(),
                                      tstart)
            ds = _dataset(tfluid, twd, files, 'InMemoryDataset')
            ds.load_into_memory()
            _record_fetches(exe, losses)
            steps = exe.train_from_dataset(
                tmain, ds, thread=thread, fetch_list=[tloss],
                print_period=1)
            losses = [float(x) for x in losses]
            runs[thread] = dict(steps=steps, losses=losses, batches=list(
                ds.batches()), final={n: scope.find_var(n).clone()
                                      for n in names})
    return dict(state=state, jfinal=jfinal, jlosses=jlosses, runs=runs,
                tmain=tmain, tstart=tstart, tloss=tloss, files=files)


def test_train_from_dataset_matches_the_jax_package(trained):
    run = trained['runs'][1]
    assert run['steps'] == len(trained['jlosses']) == 5
    np.testing.assert_allclose(run['losses'], trained['jlosses'],
                               rtol=1e-5)
    for n, v in trained['jfinal'].items():
        atol = 1e-6 if '_moment_' in n else 1e-5
        np.testing.assert_allclose(run['final'][n].numpy(), v, atol=atol,
                                   rtol=0, err_msg=n)


def test_staged_threads_and_exe_run_are_bitwise_the_same_steps(trained):
    one, two = trained['runs'][1], trained['runs'][2]
    assert one['losses'] == two['losses']
    for n in one['final']:
        assert torch.equal(one['final'][n], two['final'][n]), n
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(trained['tstart'])
        weights.load_numpy_params(scope, trained['state'],
                                  tfluid.CPUPlace(), trained['tstart'])
        losses = [float(exe.run(trained['tmain'], feed=b,
                                fetch_list=[trained['tloss']])[0])
                  for b in one['batches']]
        assert losses == one['losses']
        for n, v in one['final'].items():
            assert torch.equal(scope.find_var(n), v), n


def test_infer_from_dataset_updates_nothing_and_reclones(trained):
    main, start, loss = trained['tmain'], trained['tstart'], \
        trained['tloss']
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    ds = _dataset(tfluid, twd, trained['files'], 'QueueDataset')
    with tfluid.scope_guard(scope):
        exe.run(start)
        before = {p.name: scope.find_var(p.name).clone()
                  for p in main.all_parameters()}
        losses = []
        _record_fetches(exe, losses)
        steps = exe.infer_from_dataset(main, ds, fetch_list=[loss],
                                       print_period=1)
        del exe.run
        assert steps == 5 and len(losses) == 5
        for n, v in before.items():
            assert torch.equal(scope.find_var(n), v), n
        clone = main._infer_clone
        exe.infer_from_dataset(main, ds, fetch_list=[loss])
        assert main._infer_clone is clone
        with tfluid.program_guard(main):
            tfluid.layers.scale(loss, scale=2.0)
        exe.infer_from_dataset(main, ds, fetch_list=[loss])
        assert main._infer_clone is not clone
        assert main._infer_clone[0] == main._version
        assert not any(op.attrs.get('__op_role__') in ('backward',
                                                       'optimize')
                       for op in main._infer_clone[1].global_block().ops)


def test_dataset_loader_drops_the_short_batch(trained):
    ds = _dataset(tfluid, twd, trained['files'], 'InMemoryDataset')
    ds.load_into_memory()
    for drop_last, sizes in ((True, [16] * 4), (False, [16] * 4 + [6])):
        loader = tfluid.io.DataLoader.from_dataset(
            ds, [tfluid.CPUPlace()], drop_last=drop_last)
        assert [int(b['label'].shape[0]) for b in loader] == sizes


def test_trainer_factory_surface_is_the_jax_packages():
    from paddle_tpu.fluid import trainer_desc as jtd
    from paddle_tpu_torch.fluid import device_worker as tdw
    from paddle_tpu_torch.fluid import trainer_desc as ttd
    for opt in (None, {'trainer': 'DistMultiTrainer',
                       'device_worker': 'DownpourSGD',
                       'fleet_desc': {'tables': 1}, 'thread_num': 7},
                {'trainer': 'PipelineTrainer', 'device_worker': 'Section'}):
        descs = []
        for mod in (jtd, ttd):
            t = mod.TrainerFactory()._create_trainer(opt)
            t._set_debug(True)
            t._gen_trainer_desc()
            d = t._desc()
            d.pop('thread_num') if opt is None else None
            descs.append((type(t).__name__,
                          type(t._device_worker).__name__, d))
        assert descs[0] == descs[1]
    with pytest.raises(ValueError):
        ttd.TrainerFactory()._create_trainer({'trainer': 'NopeTrainer'})
    with pytest.raises(ValueError):
        tdw.DeviceWorkerFactory()._create_device_worker('nope')
    with pytest.raises(NotImplementedError):
        tdw.DeviceWorker()._gen_worker_desc({})

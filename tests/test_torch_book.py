"""The programs of the JAX package's tests/test_book.py and
tests/test_models.py (all but gpt) through the port, on the CPU, held
to the JAX package's results.  Each program is built by one function in
both packages, must serialize alike (same_program), and trains from the
JAX package's startup values (carried by weights.py) on the same
batches: the port's dataset loaders and reader decorators feed the port
where the JAX test reads a loader (uci_housing, mnist), each package
its own, under the same `random` seed for reader.shuffle.

Tolerances, per-step losses of free runs (the port on its own state
from the carried startup values on), relative:

- LOSS_SGD = 1e-5: fit_a_line (SGD on a linear model, well
  conditioned; the predictor's outputs on uci_housing.test() as well);
- LOSS_ADAM = 1e-4: the Adam programs (recognize_digits' MLP, the
  Wide&Deep, word2vec, BERT-tiny and Transformer-tiny).  Adam divides
  by sqrt(v) + epsilon at the default epsilon 1e-8 (Queue 3's parity
  list), so each step's rounding moves the next steps a little more;
- LOSS_MOMENTUM = 1e-4: ResNet-18 at 32 x 32 with Momentum, each
  step in lockstep from the JAX package's state (its free run is
  chaotic at batch 8).

BERT-tiny and Transformer-tiny are held at TINY's widths with their
dropout off: the JAX package's dropout ops draw from jax threefry,
which torch cannot reproduce (tests/test_torch_train_parity.py).  At
TINY itself, dropout 0.1, the programs are compared and the port's
losses must fall, as the JAX tests assert.
"""

import copy
import random

import numpy as np

import paddle_tpu.fluid as jfluid
import paddle_tpu.reader as jreader
from paddle_tpu import dataset as jds
from paddle_tpu import models as jmodels
from paddle_tpu.inference import (AnalysisConfig as JConfig,
                                  create_paddle_predictor as jpredictor)

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch import dataset as tds
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import weights
from paddle_tpu_torch.inference import (AnalysisConfig as TConfig,
                                        create_paddle_predictor as tpredictor)

from torch_program_cases import same_program

LOSS_SGD = 1e-5
LOSS_ADAM = 1e-4
LOSS_MOMENTUM = 1e-4

PKGS = {'jax': (jfluid, jreader, jds, jmodels),
        'torch': (tfluid, treader, tds, tmodels)}


def _programs(build, seed):
    """{'jax' / 'torch': (main, startup, out)}: out = build(fluid,
    models) in each package's program and unique_name guards."""
    out = {}
    for key, (fluid, _, _, models) in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            res = build(fluid, models)
        out[key] = (main, startup, res)
    same_program(out['jax'][0], out['torch'][0])
    same_program(out['jax'][1], out['torch'][1])
    return out


def _train(progs, key, batches, loss_of, after=None, state=None):
    """Losses of `key`'s program over `batches(key)` (each a feed dict),
    from the JAX startup state `state` where given; `after(exe, main,
    out)` runs in the scope after the last step."""
    fluid = PKGS[key][0]
    main, startup, out = progs[key]
    place = fluid.CPUPlace()
    losses = []
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        exe.run(startup)
        if key == 'jax':
            state = weights.numpy_state(fluid.global_scope(),
                                        weights.startup_names(
                                            progs['torch'][1]))
        else:
            weights.load_numpy_params(fluid.global_scope(), state, place,
                                      startup)
        for feed in batches(key):
            value = exe.run(main, feed=feed, fetch_list=[loss_of(out)])[0]
            losses.append(float(np.asarray(value).reshape(-1)[0]))
        extra = after(exe, main, out) if after else None
    return losses, state, extra


def _both(progs, batches, loss_of, after=None):
    jl, state, jx = _train(progs, 'jax', batches, loss_of, after)
    tl, _, tx = _train(progs, 'torch', batches, loss_of, after, state)
    return np.array(jl), np.array(tl), jx, tx




def test_fit_a_line(tmp_path):
    """Reference book/test_fit_a_line.py: 6 epochs of uci_housing through
    reader.shuffle / reader.batch and a DataFeeder, then the inference
    model saved and served by each package's predictor on the first 8
    samples of uci_housing.test()."""
    def build(fluid, models):
        x = fluid.layers.data('x', shape=[13], dtype='float32')
        y = fluid.layers.data('y', shape=[1], dtype='float32')
        y_predict = fluid.layers.fc(input=x, size=1, act=None)
        cost = fluid.layers.square_error_cost(input=y_predict, label=y)
        avg_loss = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.05).minimize(avg_loss)
        return x, y, y_predict, avg_loss
    progs = _programs(build, 1)

    def batches(key):
        fluid, reader, ds, _ = PKGS[key]
        x, y = progs[key][2][:2]
        feeder = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[x, y])
        train = reader.batch(reader.shuffle(ds.uci_housing.train(),
                                            buf_size=500), batch_size=20)
        random.seed(7)
        for _ in range(6):
            for batch in train():
                yield feeder.feed(batch)

    def save(exe, main, out):
        d = str(tmp_path / ('model_%s' % id(exe)))
        PKGS['jax' if isinstance(exe, jfluid.Executor) else 'torch'][0] \
            .io.save_inference_model(d, ['x'], [out[2]], exe, main)
        return d

    jl, tl, jdir, tdir = _both(progs, batches, lambda out: out[3], save)
    assert len(jl) == 6 * 21 and tl[-1] < tl[0] * 0.3, (tl[0], tl[-1])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_SGD)
    outs = []
    for key, d in (('jax', jdir), ('torch', tdir)):
        ds = PKGS[key][2]
        xs = np.stack([b[0] for b in list(ds.uci_housing.test()())[:8]])
        if key == 'jax':
            pred = jpredictor(JConfig(d))
        else:
            config = TConfig(d)
            config.disable_gpu()
            pred = tpredictor(config)
        outs.append(pred.run([xs])[0].as_ndarray())
    assert outs[1].shape == (8, 1)
    np.testing.assert_allclose(outs[1], outs[0], rtol=LOSS_SGD,
                               atol=LOSS_SGD * np.abs(outs[0]).max())


def test_recognize_digits_reader_pipeline():
    """Reference book/test_recognize_digits.py (the MLP): 3 epochs of
    mnist.train() in batches of 64 through a DataFeeder, Adam 1e-3."""
    def build(fluid, models):
        img = fluid.layers.data('img', shape=[784], dtype='float32')
        label = fluid.layers.data('label', shape=[1], dtype='int64')
        h = fluid.layers.fc(img, 128, act='relu')
        pred = fluid.layers.fc(h, 10, act='softmax')
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        fluid.optimizer.Adam(1e-3).minimize(loss)
        return img, label, loss, acc
    progs = _programs(build, 2)

    def batches(key):
        fluid, reader, ds, _ = PKGS[key]
        feeder = fluid.DataFeeder(place=fluid.CPUPlace(),
                                  feed_list=list(progs[key][2][:2]))
        train = reader.batch(ds.mnist.train(), batch_size=64,
                             drop_last=True)
        for _ in range(3):
            for batch in train():
                yield feeder.feed(batch)

    def accuracy(exe, main, out):
        fluid, reader, ds, _ = PKGS['jax' if isinstance(
            exe, jfluid.Executor) else 'torch']
        feeder = fluid.DataFeeder(place=fluid.CPUPlace(),
                                  feed_list=list(out[:2]))
        test = main.clone(for_test=True)
        batch = next(reader.batch(ds.mnist.test(), 256)())
        return float(np.asarray(exe.run(test, feed=feeder.feed(batch),
                                        fetch_list=[out[3]])[0]))

    jl, tl, jacc, tacc = _both(progs, batches, lambda out: out[2],
                               accuracy)
    assert len(tl) == 96
    np.testing.assert_allclose(tl, jl, rtol=LOSS_ADAM)
    assert tacc > 0.9 and abs(tacc - jacc) <= 1.0 / 256, (tacc, jacc)


def test_reader_decorators():
    def base():
        return iter(range(10))
    for reader in (jreader, treader):
        b = list(reader.batch(base, 3)())
        assert b[0] == [0, 1, 2] and b[-1] == [9]
        random.seed(3)
        assert sorted(reader.shuffle(base, 100)()) == list(range(10))
        assert list(reader.buffered(base, 2)()) == list(range(10))
        assert list(reader.map_readers(lambda a: a * 2, base)()) == \
            [i * 2 for i in range(10)]
        assert sorted(reader.xmap_readers(lambda a: a + 1, base, 2, 4)()) \
            == [i + 1 for i in range(10)]
    for buf in (3, 100):
        random.seed(11)
        want = list(jreader.shuffle(base, buf)())
        random.seed(11)
        assert list(treader.shuffle(base, buf)()) == want


def _no_dropout(cfg):
    cfg = copy.copy(cfg)
    cfg.dropout = 0.0
    if hasattr(cfg, 'attn_dropout'):
        cfg.attn_dropout = 0.0
    return cfg


def _model_case(build, make, opt, steps, seed=17):
    """The JAX test's _train: the program, `opt(fluid)` minimizing its
    loss, `steps` batches of `make(rng)` from RandomState(0); both
    packages' per-step losses."""
    def wrap(fluid, models):
        feeds, _, loss = build(fluid, models)
        opt(fluid).minimize(loss)
        return loss
    progs = _programs(wrap, seed)
    # the JAX tests draw their batches from RandomState(0)
    rng = np.random.RandomState(0)
    feeds = [make(rng) for _ in range(steps)]
    jl, tl, _, _ = _both(progs, lambda key: feeds, lambda out: out)
    return jl, tl


def test_bert_tiny_trains():
    jl, tl = _model_case(
        lambda f, m: m.bert.build_pretrain(m.bert.TINY, seq_len=32),
        lambda rng: jmodels.bert.synthetic_batch(jmodels.bert.TINY, 8, 32,
                                                 rng),
        lambda f: f.optimizer.Adam(1e-3), 15)
    assert tl[-1] < tl[0], tl
    cfg = _no_dropout(jmodels.bert.TINY)
    jl, tl = _model_case(
        lambda f, m: m.bert.build_pretrain(cfg, seq_len=32),
        lambda rng: jmodels.bert.synthetic_batch(cfg, 8, 32, rng),
        lambda f: f.optimizer.Adam(1e-3), 15)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_ADAM)


def test_transformer_tiny_trains():
    def make(cfg):
        cache = {}

        def batch(rng):
            if 'b' not in cache:
                cache['b'] = jmodels.transformer.synthetic_batch(
                    cfg, 8, 16, 16, rng)
            return cache['b']
        return batch
    tiny = jmodels.transformer.TINY
    jl, tl = _model_case(
        lambda f, m: m.transformer.build(m.transformer.TINY, src_len=16,
                                         tgt_len=16),
        make(tiny), lambda f: f.optimizer.Adam(1e-3), 15)
    assert tl[-1] < tl[0], tl
    cfg = _no_dropout(tiny)
    jl, tl = _model_case(
        lambda f, m: m.transformer.build(cfg, src_len=16, tgt_len=16),
        make(cfg), lambda f: f.optimizer.Adam(1e-3), 15)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_ADAM)


def test_wide_deep_trains():
    cfg = jmodels.wide_deep.TINY
    jl, tl = _model_case(
        lambda f, m: m.wide_deep.build(m.wide_deep.TINY),
        lambda rng: jmodels.wide_deep.synthetic_batch(cfg, 32, rng),
        lambda f: f.optimizer.Adam(5e-3), 25)
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_ADAM)


def test_word2vec_trains():
    fixed = {}

    def batch(rng):
        if not fixed:
            fixed.update(jmodels.word2vec.synthetic_batch(200, 32, rng))
        return fixed
    jl, tl = _model_case(lambda f, m: m.word2vec.build(vocab_size=200),
                         batch, lambda f: f.optimizer.Adam(5e-3), 25)
    assert tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, rtol=LOSS_ADAM)


def test_resnet18_cifar_trains():
    """At batch 8 the net is chaotic past a few steps (a relu input
    within f32 rounding of 0 falls on either side: torch_image_cases),
    so the per-step losses are held in lockstep, each port step from the
    JAX package's state before it; the port's free run as the JAX test
    asserts (its first 3 steps' states are held in
    tests/test_torch_resnet.py)."""
    def build(fluid, models):
        feeds, logits, loss, acc = models.resnet.build(
            image_shape=(3, 32, 32), class_dim=10, depth=18)
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
        return loss
    progs = _programs(build, 17)
    rng = np.random.RandomState(0)
    feeds = [{'image': rng.randn(8, 3, 32, 32).astype('float32'),
              'label': rng.randint(0, 10, (8, 1)).astype('int64')}
             for _ in range(10)]
    jl, tl, _, _ = _both(progs, lambda key: feeds, lambda out: out)
    assert np.isfinite(tl).all() and tl[-1] < 15.0, tl
    names = weights.startup_names(progs['torch'][1])
    before = []
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(progs['jax'][1])
        for feed in feeds:
            before.append(weights.numpy_state(jfluid.global_scope(), names))
            exe.run(progs['jax'][0], feed=feed)
    place = tfluid.CPUPlace()
    locked = []
    with tfluid.scope_guard(tfluid.Scope()):
        exe = tfluid.Executor(place)
        exe.run(progs['torch'][1])
        for feed, b in zip(feeds, before):
            weights.load_numpy_params(tfluid.global_scope(), b, place,
                                      progs['torch'][1])
            locked.append(float(exe.run(progs['torch'][0], feed=feed,
                                        fetch_list=[progs['torch'][2]])[0]))
    np.testing.assert_allclose(locked, jl, rtol=LOSS_MOMENTUM)


def test_resnet50_builds():
    def build(fluid, models):
        return models.resnet.build()
    progs = _programs(build, 5)
    feeds, logits, loss, acc = progs['torch'][2]
    assert tuple(logits.shape) == (-1, 1000)
    n = len(progs['torch'][0].all_parameters())
    assert n == len(progs['jax'][0].all_parameters()) and n > 150, n

"""The port's dataset loaders (paddle_tpu_torch/dataset/) against the
JAX package's (paddle_tpu/dataset/), on the CPU.

Every reader's first 64 samples are compared bitwise (same values,
dtypes and Python types): the synthetic stand-ins from their fixed
seeds, and, for each loader with a local route, tiny files written here
in the dataset's own format with both packages pointed at them (each
module's ``_HOME``, which both read from PADDLE_TPU_DATA_HOME at
import).  No tolerance: both are the same numpy draws.
"""

import gzip
import io
import itertools
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

from paddle_tpu import dataset as jds

from paddle_tpu_torch import dataset as tds

N = 64

LOADERS = ['mnist', 'uci_housing', 'imdb', 'cifar', 'imikolov', 'movielens',
           'flowers', 'wmt16', 'conll05', 'sentiment', 'voc2012', 'wmt14',
           'mq2007', 'common', 'image']


def same(got, want, where=''):
    """Bitwise equality of two samples, recursively."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
        return
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, '%s[%d]' % (where, i))
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            same(got[k], want[k], '%s[%r]' % (where, k))
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), where
    else:
        assert got == want, (where, got, want)


def same_reader(make, n=N):
    """make(dataset package) -> reader; the first `n` samples of both."""
    got = list(itertools.islice(make(tds)(), n))
    want = list(itertools.islice(make(jds)(), n))
    assert len(want) > 0
    same(got, want, 'reader')
    return got


@pytest.fixture
def home(tmp_path, monkeypatch):
    """Points every loader module of both packages at `tmp_path`."""
    for pkg in (jds, tds):
        for name in LOADERS:
            mod = getattr(pkg, name)
            if hasattr(mod, '_HOME'):
                monkeypatch.setattr(mod, '_HOME', str(tmp_path))
            if hasattr(mod, 'DATA_HOME'):
                monkeypatch.setattr(mod, 'DATA_HOME', str(tmp_path))
    return tmp_path


def test_the_same_loaders_and_names():
    for name in LOADERS:
        jm, tm = getattr(jds, name), getattr(tds, name)
        pub = lambda m: sorted(n for n in dir(m) if not n.startswith('_')  # noqa
                               and callable(getattr(m, n)) and
                               getattr(getattr(m, n), '__module__', '') ==
                               m.__name__)
        assert pub(tm) == pub(jm), name
    same(tds.movielens.age_table(), jds.movielens.age_table())
    same(tds.movielens.movie_categories(), jds.movielens.movie_categories())
    same(tds.movielens.get_movie_title_dict(),
         jds.movielens.get_movie_title_dict())
    for f in ('max_user_id', 'max_movie_id', 'max_job_id'):
        assert getattr(tds.movielens, f)() == getattr(jds.movielens, f)()
    same(tds.uci_housing.feature_names, jds.uci_housing.feature_names)
    for f in ('start_mark', 'end_mark', 'unk_mark'):
        assert getattr(tds.wmt16, f)() == getattr(jds.wmt16, f)()


def test_synthetic_image_readers():
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.mnist, f)())
    for f in ('train10', 'test10', 'train100', 'test100'):
        got = same_reader(lambda d: getattr(d.cifar, f)())
        assert got[0][0].shape == (3072,) and got[0][0].dtype == np.float32
    for f in ('train', 'test', 'valid'):
        same_reader(lambda d: getattr(d.flowers, f)(), 8)
    for f in ('train', 'test', 'val'):
        same_reader(lambda d: getattr(d.voc2012, f)(), 8)


def test_flowers_mapper_and_cycle():
    def mapper(rec):
        return rec[0][:, ::8, ::8].copy(), rec[1] + 1
    got = same_reader(lambda d: d.flowers.test(mapper=mapper, cycle=True),
                      70)
    assert got[64][1] == got[0][1]  # the second pass over 64 samples
    same_reader(lambda d: d.flowers.train(mapper=mapper), 8)


def test_synthetic_text_readers():
    same(tds.imdb.word_dict(), jds.imdb.word_dict())
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.imdb, f)(d.imdb.word_dict()))
        same_reader(lambda d: getattr(d.sentiment, f)())
    same(tds.sentiment.get_word_dict(), jds.sentiment.get_word_dict())
    for min_freq in (50, 1):
        same(tds.imikolov.build_dict(min_freq),
             jds.imikolov.build_dict(min_freq))
    for f, n in (('train', 5), ('test', 2), ('train', 3)):
        same_reader(lambda d: getattr(d.imikolov, f)(
            d.imikolov.build_dict(), n))
    for f in ('train', 'test', 'validation'):
        same_reader(lambda d: getattr(d.wmt16, f)(1000, 800))
    for f in ('train', 'test', 'gen'):
        same_reader(lambda d: getattr(d.wmt14, f)(500))
    for rev in (True, False):
        same(tds.wmt14.get_dict(30, rev), jds.wmt14.get_dict(30, rev))
    same(tds.conll05.get_dict(), jds.conll05.get_dict())
    same(tds.conll05.get_embedding(), jds.conll05.get_embedding())
    same_reader(lambda d: d.conll05.test())


def test_synthetic_tabular_readers():
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.uci_housing, f)())
        same_reader(lambda d: getattr(d.movielens, f)())
    for fmt in ('pointwise', 'pairwise', 'listwise'):
        for f in ('train', 'test'):
            same_reader(lambda d: getattr(d.mq2007, f)(fmt))
    same_reader(lambda d: d.mq2007.gen_pair(7, 3, partial_order='sampled'))


def test_image_transforms():
    im = np.random.RandomState(0).rand(37, 53, 3).astype('float32') * 255
    for size in (16, 40, 64):
        same(tds.image.resize_short(im, size),
             jds.image.resize_short(im, size))
    same(tds.image.center_crop(im, 20), jds.image.center_crop(im, 20))
    same(tds.image.left_right_flip(im), jds.image.left_right_flip(im))
    same(tds.image.to_chw(im), jds.image.to_chw(im))
    for is_train in (True, False):
        for mean in (None, [1.0, 2.0, 3.0]):
            np.random.seed(5)
            want = jds.image.simple_transform(im, 32, 24, is_train,
                                              mean=mean)
            # the global generator as the JAX module draws, then the same
            # draws from an explicit RandomState
            np.random.seed(5)
            same(tds.image.simple_transform(im, 32, 24, is_train,
                                            mean=mean), want)
            same(tds.image.simple_transform(
                im, 32, 24, is_train, mean=mean,
                rng=np.random.RandomState(5)), want)
    np.random.seed(9)
    want = jds.image.random_crop(im, 30)
    same(tds.image.random_crop(im, 30, rng=np.random.RandomState(9)), want)


def test_common_download_and_md5(home):
    for pkg in (jds, tds):
        with pytest.raises(IOError) as e:
            pkg.common.download('http://x/y/data.bin', 'mod', None)
        assert 'cannot download' in str(e.value)
    os.makedirs(home / 'mod')
    (home / 'mod' / 'data.bin').write_bytes(b'abc' * 3000)
    md5 = jds.common.md5file(str(home / 'mod' / 'data.bin'))
    assert tds.common.md5file(str(home / 'mod' / 'data.bin')) == md5
    for pkg in (jds, tds):
        assert pkg.common.download('http://x/y/data.bin', 'mod', md5) == \
            str(home / 'mod' / 'data.bin')
        with pytest.raises(IOError) as e:
            pkg.common.download('http://x/y/data.bin', 'mod', '0' * 32)
        assert 'md5 mismatch' in str(e.value)
    msgs = []
    for pkg in (jds, tds):
        try:
            pkg.common.download('http://x/y/z.bin', 'mod', None, 'w.bin')
        except IOError as err:
            msgs.append(str(err))
    assert msgs[0] == msgs[1]


def test_common_split_and_cluster_reader(tmp_path):
    def reader():
        return iter(range(23))
    for key, pkg in (('j', jds), ('t', tds)):
        pkg.common.split(reader, 5, suffix=str(tmp_path / (key + '%05d.p')))
    for key in 'jt':
        for i in range(5):
            assert (tmp_path / ('%s%05d.p' % (key, i))).read_bytes() == \
                (tmp_path / ('j%05d.p' % i)).read_bytes()
    for tid in range(3):
        same(list(tds.common.cluster_files_reader(
            str(tmp_path / 't*.p'), 3, tid)()),
            list(jds.common.cluster_files_reader(
                str(tmp_path / 'j*.p'), 3, tid)()))


def _tar_member(tar, name, obj):
    data = pickle.dumps(obj)
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def test_cifar_pickled_tar(home):
    rng = np.random.RandomState(3)
    os.makedirs(home / 'cifar')
    with tarfile.open(home / 'cifar' / 'cifar-10-python.tar.gz',
                      'w:gz') as tar:
        for i in range(2):
            _tar_member(tar, 'cifar-10-batches-py/data_batch_%d' % (i + 1), {
                b'data': rng.randint(0, 256, (5, 3072)).astype(np.uint8),
                b'labels': list(rng.randint(0, 10, 5))})
        _tar_member(tar, 'cifar-10-batches-py/test_batch', {
            b'data': rng.randint(0, 256, (4, 3072)).astype(np.uint8),
            b'labels': list(rng.randint(0, 10, 4))})
    with tarfile.open(home / 'cifar' / 'cifar-100-python.tar.gz',
                      'w:gz') as tar:
        for part, n in (('train', 6), ('test', 3)):
            _tar_member(tar, 'cifar-100-python/' + part, {
                b'data': rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                b'fine_labels': list(rng.randint(0, 100, n))})
    for f, n in (('train10', 10), ('test10', 4), ('train100', 6),
                 ('test100', 3)):
        got = same_reader(lambda d: getattr(d.cifar, f)())
        assert len(got) == n and got[0][0].min() >= -1.0


def test_uci_housing_table(home):
    rng = np.random.RandomState(4)
    os.makedirs(home / 'uci_housing')
    np.savetxt(home / 'uci_housing' / 'housing.data',
               rng.rand(20, 14) * 100, fmt='%.4f')
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.uci_housing, f)())


def test_imikolov_ptb_text(home):
    os.makedirs(home / 'imikolov')
    words = ['the', 'cat', 'sat', 'on', 'a', 'mat', 'dog']
    rng = np.random.RandomState(5)
    for name, n in (('ptb.train.txt', 30), ('ptb.valid.txt', 6)):
        with open(home / 'imikolov' / name, 'w') as f:
            for _ in range(n):
                f.write(' ' + ' '.join(rng.choice(words, rng.randint(2, 9)))
                        + ' \n')
    same(tds.imikolov.build_dict(3), jds.imikolov.build_dict(3))
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.imikolov, f)(
            d.imikolov.build_dict(3), 4))


def test_movielens_ml1m_files(home):
    d = home / 'movielens' / 'ml-1m'
    os.makedirs(d)
    (d / 'movies.dat').write_text(
        '1::Toy Story (1995)::Animation|Children\'s|Comedy\n'
        '2::Jumanji (1995)::Adventure|Fantasy\n'
        '3::Heat (1995)::Action|Crime|Thriller\n', encoding='latin1')
    (d / 'users.dat').write_text(
        '1::F::1::10::48067\n2::M::56::16::70072\n3::M::25::15::55117\n',
        encoding='latin1')
    rng = np.random.RandomState(6)
    (d / 'ratings.dat').write_text(''.join(
        '%d::%d::%d::978300760\n' % (rng.randint(1, 5), rng.randint(1, 5),
                                     rng.randint(1, 6))
        for _ in range(40)), encoding='latin1')
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.movielens, f)())


def test_wmt16_parallel_text(home):
    os.makedirs(home / 'wmt16')
    rng = np.random.RandomState(7)
    for prefix in ('train', 'test', 'val'):
        for side in ('src', 'trg'):
            with open(home / 'wmt16' / (prefix + '.' + side), 'w') as f:
                for _ in range(9):
                    f.write(' '.join(str(v) for v in rng.randint(
                        3, 60, rng.randint(1, 8))) + '\n')
    for f in ('train', 'test', 'validation'):
        same_reader(lambda d: getattr(d.wmt16, f)(40, 50))
    same_reader(lambda d: d.wmt14.train(30))


def test_flowers_npz_and_mnist_idx(home):
    os.makedirs(home / 'flowers')
    rng = np.random.RandomState(8)
    np.savez(home / 'flowers' / 'train.npz',
             images=rng.rand(3, 3, 8, 8).astype('float64'),
             labels=np.array([4, 0, 101]))
    same_reader(lambda d: d.flowers.train())
    same_reader(lambda d: d.flowers.train(cycle=True), 7)
    os.makedirs(home / 'mnist')
    for prefix, n in (('train', 6), ('t10k', 3)):
        with gzip.open(home / 'mnist' / ('%s-images-idx3-ubyte.gz'
                                         % prefix), 'wb') as f:
            f.write(struct.pack('>IIII', 2051, n, 28, 28))
            f.write(rng.randint(0, 256, n * 784).astype(np.uint8).tobytes())
        with gzip.open(home / 'mnist' / ('%s-labels-idx1-ubyte.gz'
                                         % prefix), 'wb') as f:
            f.write(struct.pack('>II', 2049, n))
            f.write(rng.randint(0, 10, n).astype(np.uint8).tobytes())
    for f in ('train', 'test'):
        same_reader(lambda d: getattr(d.mnist, f)())

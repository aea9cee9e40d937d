"""Dataset plumbing (reference python/paddle/dataset/common.py):
download/md5 helpers and the cluster file-split used by distributed
readers.  Zero-egress: download() resolves only local paths."""

import hashlib
import os

DATA_HOME = os.environ.get('PADDLE_TPU_DATA_HOME',
                           os.path.expanduser('~/.cache/paddle_tpu'))


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    h = hashlib.md5()
    with open(fname, 'rb') as f:
        for chunk in iter(lambda: f.read(4096), b''):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Zero-egress rendering: the file must already exist under
    DATA_HOME/module_name; raises with a clear message otherwise."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name or url.split('/')[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise IOError('%s exists but md5 mismatch' % filename)
        return filename
    raise IOError(
        'cannot download %s (zero-egress environment); place the file '
        'at %s or use the synthetic loaders' % (url, filename))


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    import pickle
    dumper = dumper or pickle.dump
    lines = []
    idx = 0
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            with open(suffix % idx, 'wb') as f:
                dumper(lines, f)
            lines = []
            idx += 1
    if lines:
        with open(suffix % idx, 'wb') as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    import glob
    import pickle
    loader = loader or pickle.load

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fn in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fn, 'rb') as f:
                    for d in loader(f):
                        yield d
    return reader

"""WMT14 en-fr loader (reference python/paddle/dataset/wmt14.py API:
train/test/gen/get_dict). Zero-egress: delegates to the wmt16-style
synthetic parallel-corpus generator with the wmt14 id conventions
(<s>=0, <e>=1, <unk>=2)."""

from . import wmt16

START = "<s>"
END = "<e>"
UNK = "<unk>"


def train(dict_size):
    return wmt16.train(dict_size, dict_size)


def test(dict_size):
    return wmt16.test(dict_size, dict_size)


def gen(dict_size):
    return wmt16.test(dict_size, dict_size)


def get_dict(dict_size, reverse=True):
    """Returns (src_dict, trg_dict); id->word when reverse (the
    reference contract, wmt14.py:155)."""
    word_dict = {('w%d' % i): i for i in range(dict_size)}
    if reverse:
        rev = {v: k for k, v in word_dict.items()}
        return rev, dict(rev)
    return word_dict, dict(word_dict)


def fetch():
    pass

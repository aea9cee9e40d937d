"""WMT16 en-de loader (reference python/paddle/dataset/wmt16.py API):
train/test/validation readers yield (src_ids, trg_ids, trg_ids_next)
tuples — the machine-translation / Transformer book-chapter input.

Reads tokenized files from $PADDLE_TPU_DATA_HOME/wmt16 when present;
otherwise serves a deterministic synthetic parallel corpus where the
target is an invertible transform of the source, so seq2seq models can
actually learn the mapping.
"""

import os

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')


def start_mark():
    return 0


def end_mark():
    return 1


def unk_mark():
    return 2


def _synthetic_pairs(n, src_vocab, trg_vocab, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(3, 12))
        src = [int(rng.randint(3, src_vocab)) for _ in range(length)]
        # deterministic "translation": reverse + vocab shift
        trg = [3 + (w - 3 + 7) % (trg_vocab - 3) for w in reversed(src)]
        yield src, trg


def _file_pairs(prefix, src_vocab, trg_vocab):
    src_p = os.path.join(_HOME, 'wmt16', prefix + '.src')
    trg_p = os.path.join(_HOME, 'wmt16', prefix + '.trg')
    with open(src_p) as fs, open(trg_p) as ft:
        for s_line, t_line in zip(fs, ft):
            src = [min(int(w), src_vocab - 1)
                   for w in s_line.split()]
            trg = [min(int(w), trg_vocab - 1)
                   for w in t_line.split()]
            yield src, trg


def _reader(prefix, src_dict_size, trg_dict_size, n_synth, seed):
    def reader():
        has_files = _HOME and os.path.exists(
            os.path.join(_HOME, 'wmt16', prefix + '.src'))
        pairs = _file_pairs(prefix, src_dict_size, trg_dict_size) \
            if has_files else _synthetic_pairs(
                n_synth, src_dict_size, trg_dict_size, seed)
        s, e = start_mark(), end_mark()
        for src, trg in pairs:
            src_ids = [s] + src + [e]
            trg_ids = [s] + trg
            trg_next = trg + [e]
            yield src_ids, trg_ids, trg_next
    return reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    return _reader('train', src_dict_size, trg_dict_size, 2000, 41)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    return _reader('test', src_dict_size, trg_dict_size, 200, 42)


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang='en'):
    return _reader('val', src_dict_size, trg_dict_size, 200, 43)

"""PTB language-model loader (reference python/paddle/dataset/imikolov.py
API): build_dict() then train(word_idx, n)/test(word_idx, n) yielding
n-gram tuples of word ids (the word2vec book-chapter input).

Reads ptb.train.txt/ptb.valid.txt from $PADDLE_TPU_DATA_HOME/imikolov
when present; otherwise serves a deterministic synthetic corpus with
Zipfian unigrams and strong bigram structure so embeddings converge.
"""

import collections
import os

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')
N_SYNTH_VOCAB = 200


def _local(name):
    return os.path.join(_HOME, 'imikolov', name) if _HOME else None


def _synthetic_corpus(n_sentences, seed):
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, N_SYNTH_VOCAB + 1)
    probs /= probs.sum()
    for _ in range(n_sentences):
        length = int(rng.randint(5, 20))
        words, w = [], int(rng.choice(N_SYNTH_VOCAB, p=probs))
        for _ in range(length):
            words.append('w%d' % w)
            # bigram structure: usually step to (w*3+1) mod V
            w = (w * 3 + 1) % N_SYNTH_VOCAB if rng.rand() < 0.7 \
                else int(rng.choice(N_SYNTH_VOCAB, p=probs))
        yield words


def _sentences(fname, n_synth, seed):
    p = _local(fname)
    if p and os.path.exists(p):
        with open(p) as f:
            for line in f:
                yield line.strip().split()
    else:
        yield from _synthetic_corpus(n_synth, seed)


def build_dict(min_word_freq=50):
    """word -> id; '<unk>' maps the tail (reference imikolov.py
    build_dict)."""
    freq = collections.Counter()
    for s in _sentences('ptb.train.txt', 2000, 5):
        freq.update(s)
    freq = {k: v for k, v in freq.items() if v >= min_word_freq}
    words = sorted(freq, key=lambda k: (-freq[k], k))
    word_idx = {w: i for i, w in enumerate(words)}
    word_idx['<unk>'] = len(words)
    return word_idx


def _ngram_reader(fname, word_idx, n, n_synth, seed):
    def reader():
        unk = word_idx['<unk>']
        for s in _sentences(fname, n_synth, seed):
            ids = [word_idx.get('<s>', unk)] + \
                [word_idx.get(w, unk) for w in s] + \
                [word_idx.get('<e>', unk)]
            for i in range(n, len(ids) + 1):
                yield tuple(ids[i - n:i])
    return reader


def train(word_idx, n):
    return _ngram_reader('ptb.train.txt', word_idx, n, 2000, 5)


def test(word_idx, n):
    return _ngram_reader('ptb.valid.txt', word_idx, n, 200, 6)

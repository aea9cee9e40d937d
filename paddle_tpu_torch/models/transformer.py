"""Transformer NMT seq2seq (BASELINE.json config 4), built with the
port's fluid layers into the same Programs the JAX package builds
(models/transformer.py).

Reference workload: variable-length LoDTensor paths.  As in the JAX
package, batches are padded to a length bucket and mask tensors drive
attention and the loss.  The position encoding and the decoder's causal
bias are ops sized from the runtime length (ops/misc_ops.py), so one
Program trains every bucket up to the length it was built for.
Training only: beam-search decoding needs control flow.
"""

import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.layer_helper import LayerHelper


class TransformerConfig(object):
    def __init__(self, src_vocab=10000, tgt_vocab=10000, d_model=512,
                 heads=8, ffn=2048, enc_layers=6, dec_layers=6,
                 dropout=0.1, max_len=256):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.d_model = d_model
        self.heads = heads
        self.ffn = ffn
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.dropout = dropout
        self.max_len = max_len


# the base model of Vaswani et al. 2017
BASE = TransformerConfig()
TINY = TransformerConfig(src_vocab=500, tgt_vocab=500, d_model=64,
                         heads=4, ffn=128, enc_layers=2, dec_layers=2,
                         max_len=64)


def _dropout(x, cfg, is_test):
    if is_test or not cfg.dropout:
        return x
    return layers.dropout(x, cfg.dropout, is_test=is_test,
                          dropout_implementation='upscale_in_train')


def _attention(q_in, kv_in, bias, cfg, is_test):
    h, heads = cfg.d_model, cfg.heads
    d = h // heads
    q = layers.fc(q_in, size=h, num_flatten_dims=2)
    k = layers.fc(kv_in, size=h, num_flatten_dims=2)
    v = layers.fc(kv_in, size=h, num_flatten_dims=2)

    def to_heads(t):
        t = layers.reshape(t, [0, 0, heads, d])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = to_heads(q), to_heads(k), to_heads(v)
    scores = layers.matmul(q, k, transpose_y=True, alpha=d ** -0.5)
    if bias is not None:
        scores = layers.elementwise_add(scores, bias)
    probs = _dropout(layers.softmax(scores), cfg, is_test)
    ctx = layers.matmul(probs, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    return layers.fc(ctx, size=h, num_flatten_dims=2)


def _ffn(x, cfg, is_test):
    out = layers.fc(x, size=cfg.ffn, num_flatten_dims=2, act='relu')
    out = _dropout(out, cfg, is_test)
    return layers.fc(out, size=cfg.d_model, num_flatten_dims=2)


def _add_norm(x, sub):
    return layers.layer_norm(layers.elementwise_add(x, sub),
                             begin_norm_axis=2)


def _embed(ids, vocab, seq_len, cfg, is_test):
    emb = layers.embedding(ids, size=[vocab, cfg.d_model])
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    helper = LayerHelper('position_encoding')
    pe = helper.create_variable_for_type_inference(emb.dtype)
    pe.stop_gradient = True
    helper.append_op('position_encoding', inputs={'X': emb},
                     outputs={'Out': pe},
                     attrs={'d_model': cfg.d_model}, infer_shape=False)
    pe.shape = (1, seq_len, cfg.d_model)
    return _dropout(layers.elementwise_add(emb, pe), cfg, is_test)


def _pad_bias(mask):
    """[B, T] 1/0 mask -> additive [B, 1, 1, T]."""
    return layers.scale(
        layers.unsqueeze(layers.unsqueeze(mask, [1]), [1]),
        scale=10000.0, bias=-10000.0)


def causal_bias(x, seq_len):
    """The additive causal bias [1, 1, T, T] sized from x's runtime
    length (a causal_mask_like op)."""
    helper = LayerHelper('causal_mask_like')
    b = helper.create_variable_for_type_inference(x.dtype)
    b.stop_gradient = True
    helper.append_op('causal_mask_like', inputs={'X': x},
                     outputs={'Out': b}, infer_shape=False)
    b.shape = (1, 1, seq_len, seq_len)
    return b


def encoder(src_ids, src_mask, seq_len, cfg, is_test=False):
    x = _embed(src_ids, cfg.src_vocab, seq_len, cfg, is_test)
    bias = _pad_bias(src_mask)
    for _ in range(cfg.enc_layers):
        x = _add_norm(x, _attention(x, x, bias, cfg, is_test))
        x = _add_norm(x, _ffn(x, cfg, is_test))
    return x, bias


def decoder(tgt_ids, enc_out, enc_bias, tgt_len, cfg, is_test=False):
    x = _embed(tgt_ids, cfg.tgt_vocab, tgt_len, cfg, is_test)
    self_bias = causal_bias(x, tgt_len)
    for _ in range(cfg.dec_layers):
        x = _add_norm(x, _attention(x, x, self_bias, cfg, is_test))
        x = _add_norm(x, _attention(x, enc_out, enc_bias, cfg, is_test))
        x = _add_norm(x, _ffn(x, cfg, is_test))
    return layers.fc(x, size=cfg.tgt_vocab, num_flatten_dims=2)


def build(cfg=None, src_len=64, tgt_len=64, is_test=False,
          label_smooth_eps=0.1):
    """-> (feeds, logits, loss): the token-mean cross entropy of the
    target over its mask, against one-hot labels smoothed by
    label_smooth_eps (soft-label softmax_with_cross_entropy), or the
    hard labels where it is 0."""
    cfg = cfg or BASE
    src = layers.data('src_ids', shape=[src_len], dtype='int64')
    src_mask = layers.data('src_mask', shape=[src_len], dtype='float32')
    tgt = layers.data('tgt_ids', shape=[tgt_len], dtype='int64')
    tgt_label = layers.data('tgt_label', shape=[tgt_len], dtype='int64')
    tgt_mask = layers.data('tgt_mask', shape=[tgt_len], dtype='float32')

    enc_out, enc_bias = encoder(src, src_mask, src_len, cfg, is_test)
    logits = decoder(tgt, enc_out, enc_bias, tgt_len, cfg, is_test)

    if label_smooth_eps:
        oh = layers.one_hot(tgt_label, depth=cfg.tgt_vocab)
        smooth = layers.label_smooth(oh, epsilon=label_smooth_eps)
        ce = layers.softmax_with_cross_entropy(logits, smooth,
                                               soft_label=True)
    else:
        ce = layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(tgt_label, [2]))
        ce = layers.squeeze(ce, [2])
    if len(ce.shape) == 3:
        ce = layers.squeeze(ce, [2]) if ce.shape[2] == 1 else \
            layers.reduce_sum(ce, dim=2)
    weighted = layers.elementwise_mul(ce, tgt_mask)
    denom = layers.reduce_sum(tgt_mask)
    loss = layers.elementwise_div(layers.reduce_sum(weighted), denom)
    feeds = {'src_ids': src, 'src_mask': src_mask, 'tgt_ids': tgt,
             'tgt_label': tgt_label, 'tgt_mask': tgt_mask}
    return feeds, logits, loss


def synthetic_batch(cfg, batch, src_len, tgt_len, rng):
    """A variable-length batch padded to the bucket: source and target
    lengths drawn from [len // 2, len], ids from [1, vocab), the target
    label the target shifted by one, masks of 1 over each row's
    length."""
    src_lens = rng.randint(src_len // 2, src_len + 1, batch)
    tgt_lens = rng.randint(tgt_len // 2, tgt_len + 1, batch)
    src = np.zeros((batch, src_len), 'int64')
    smask = np.zeros((batch, src_len), 'float32')
    tgt = np.zeros((batch, tgt_len), 'int64')
    tlabel = np.zeros((batch, tgt_len), 'int64')
    tmask = np.zeros((batch, tgt_len), 'float32')
    for b in range(batch):
        src[b, :src_lens[b]] = rng.randint(1, cfg.src_vocab,
                                           src_lens[b])
        smask[b, :src_lens[b]] = 1
        seq = rng.randint(1, cfg.tgt_vocab, tgt_lens[b] + 1)
        tgt[b, :tgt_lens[b]] = seq[:-1]
        tlabel[b, :tgt_lens[b]] = seq[1:]
        tmask[b, :tgt_lens[b]] = 1
    return {'src_ids': src, 'src_mask': smask, 'tgt_ids': tgt,
            'tgt_label': tlabel, 'tgt_mask': tmask}

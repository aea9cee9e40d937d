"""BERT encoder and pretraining heads (BASELINE.json config 2), built
with the port's fluid layers into the same Programs the JAX package
builds (models/bert.py).

Reference workload: fused_attention + layer_norm + adam on the
reference's multihead_matmul fused op (operators/fused/
multihead_matmul_op.*).  At seq >= flash_min_len the attention chain is
ONE fused_multihead_attention op, which runs the hand-written
flash-attention kernels on the GPU (forward, in-kernel attention
dropout, backward).  Below flash_min_len it is the JAX package's naive
chain: reshape, transpose2, matmul (f32 products), the key bias
broadcast as [B, 1, 1, T] (and a causal_mask_like bias where causal),
softmax, attention dropout, matmul, transpose2, reshape.
"""

import numpy as np

from ..fluid import layers
from ..fluid.layer_helper import LayerHelper


class BertConfig(object):
    def __init__(self, vocab_size=30522, hidden=768, layers=12, heads=12,
                 intermediate=3072, max_pos=512, type_vocab=2,
                 dropout=0.1, attn_dropout=None, use_flash=True):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.heads = heads
        self.intermediate = intermediate
        self.max_pos = max_pos
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.attn_dropout = dropout if attn_dropout is None \
            else attn_dropout
        self.use_flash = use_flash
        # the JAX package's choice (measured on a TPU); it decides the
        # Program's structure, which must stay identical in both packages
        self.flash_min_len = 512


BASE = BertConfig()
TINY = BertConfig(vocab_size=1000, hidden=64, layers=2, heads=4,
                  intermediate=128, max_pos=128)


def multi_head_attention(x, attn_bias, cfg, is_test, key_bias=None,
                         causal=False):
    """Self-attention: fused QKV projection -> scaled dot product ->
    output projection.  The scaled-dot-product chain is one
    fused_multihead_attention op when the sequence reaches
    cfg.flash_min_len and the mask comes as a [B, T] key bias."""
    if getattr(cfg, 'use_context_parallel', False):
        raise NotImplementedError(
            'context-parallel attention is not ported yet')
    h, heads = cfg.hidden, cfg.heads
    d = h // heads
    qkv = layers.fc(x, size=3 * h, num_flatten_dims=2)
    q, k, v = layers.split(qkv, 3, dim=2)

    seq_len = x.shape[1] if len(x.shape) >= 2 else 0
    use_flash = getattr(cfg, 'use_flash', False) and \
        (seq_len is None or seq_len < 0 or
         seq_len >= getattr(cfg, 'flash_min_len', 1024)) and \
        (attn_bias is None or key_bias is not None)
    if use_flash:
        def to_bthd(t):
            return layers.reshape(t, [0, 0, heads, d])

        q3, k3, v3 = to_bthd(q), to_bthd(k), to_bthd(v)
        helper = LayerHelper('fused_multihead_attention')
        out = helper.create_variable_for_type_inference(x.dtype)
        inputs = {'Q': q3, 'K': k3, 'V': v3}
        if key_bias is not None:
            inputs['KeyBias'] = key_bias
        adrop = 0.0 if is_test else float(
            getattr(cfg, 'attn_dropout', cfg.dropout) or 0.0)
        helper.append_op('fused_multihead_attention', inputs=inputs,
                         outputs={'Out': out},
                         attrs={'causal': bool(causal),
                                'dropout_rate': adrop},
                         infer_shape=False)
        out.shape = tuple(q3.shape)
        ctx = layers.reshape(out, [0, 0, h])
        return layers.fc(ctx, size=h, num_flatten_dims=2)

    def to_heads(t):
        t = layers.reshape(t, [0, 0, heads, d])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = to_heads(q), to_heads(k), to_heads(v)
    scores = layers.matmul(q, k, transpose_y=True, alpha=d ** -0.5)
    if causal:
        from .transformer import causal_bias
        scores = layers.elementwise_add(
            scores, causal_bias(x, x.shape[1] or -1))
    if attn_bias is not None:
        scores = layers.elementwise_add(scores, attn_bias)
    probs = layers.softmax(scores)
    if not is_test and getattr(cfg, 'attn_dropout', cfg.dropout):
        probs = layers.dropout(probs,
                               getattr(cfg, 'attn_dropout', cfg.dropout),
                               is_test=is_test,
                               dropout_implementation='upscale_in_train')
    ctx = layers.matmul(probs, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    return layers.fc(ctx, size=h, num_flatten_dims=2)


def encoder_layer(x, attn_bias, cfg, is_test, key_bias=None):
    attn = multi_head_attention(x, attn_bias, cfg, is_test,
                                key_bias=key_bias)
    if not is_test and cfg.dropout:
        attn = layers.dropout(attn, cfg.dropout, is_test=is_test,
                              dropout_implementation='upscale_in_train')
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=2)
    ffn = layers.fc(x, size=cfg.intermediate, num_flatten_dims=2,
                    act='gelu')
    ffn = layers.fc(ffn, size=cfg.hidden, num_flatten_dims=2)
    if not is_test and cfg.dropout:
        ffn = layers.dropout(ffn, cfg.dropout, is_test=is_test,
                             dropout_implementation='upscale_in_train')
    return layers.layer_norm(layers.elementwise_add(x, ffn),
                             begin_norm_axis=2)


def bert_encoder(src_ids, pos_ids, sent_ids, input_mask, cfg,
                 is_test=False):
    emb = layers.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden])
    pos = layers.embedding(pos_ids, size=[cfg.max_pos, cfg.hidden])
    sent = layers.embedding(sent_ids, size=[cfg.type_vocab, cfg.hidden])
    x = layers.elementwise_add(layers.elementwise_add(emb, pos), sent)
    x = layers.layer_norm(x, begin_norm_axis=2)
    if not is_test and cfg.dropout:
        x = layers.dropout(x, cfg.dropout, is_test=is_test,
                           dropout_implementation='upscale_in_train')
    # [B, T] mask -> additive bias: 0 where attended, -10000 where
    # padded.  The flash path consumes the [B, T] form directly; the
    # naive chain broadcasts the [B, 1, 1, T] form over heads/rows.
    key_bias = layers.scale(input_mask, scale=10000.0, bias=-10000.0)
    bias = layers.unsqueeze(layers.unsqueeze(key_bias, [1]), [1])
    for _ in range(cfg.layers):
        x = encoder_layer(x, bias, cfg, is_test, key_bias=key_bias)
    return x


def encoder_feeds(seq_len):
    """The four encoder inputs as data layers:
    {'src_ids', 'pos_ids', 'sent_ids': int64 [-1, seq_len],
     'input_mask': float32 [-1, seq_len]}."""
    feeds = {n: layers.data(n, shape=[seq_len], dtype='int64')
             for n in ('src_ids', 'pos_ids', 'sent_ids')}
    feeds['input_mask'] = layers.data('input_mask', shape=[seq_len],
                                      dtype='float32')
    return feeds


def encoder_batch(cfg, batch, seq_len, rng, pad_to=None):
    """A request for the encoder: random token ids, positions 0..T-1,
    sentence 0, and an input mask of ones, or ones over the first
    `pad_to` positions of each row (the rest padding)."""
    src = rng.randint(0, cfg.vocab_size, (batch, seq_len)).astype('int64')
    pos = np.tile(np.arange(seq_len), (batch, 1)).astype('int64')
    sent = np.zeros((batch, seq_len), 'int64')
    mask = np.ones((batch, seq_len), 'float32')
    if pad_to is not None:
        mask[:, pad_to:] = 0.0
    return {'src_ids': src, 'pos_ids': pos, 'sent_ids': sent,
            'input_mask': mask}


def build_pretrain(cfg=None, seq_len=128, is_test=False):
    """Masked-LM + next-sentence pretraining heads (the reference BERT
    pretraining workload) -> (feeds, encoder output, loss)."""
    cfg = cfg or BASE
    src = layers.data('src_ids', shape=[seq_len], dtype='int64')
    pos = layers.data('pos_ids', shape=[seq_len], dtype='int64')
    sent = layers.data('sent_ids', shape=[seq_len], dtype='int64')
    mask = layers.data('input_mask', shape=[seq_len], dtype='float32')
    mlm_label = layers.data('mlm_label', shape=[seq_len], dtype='int64')
    nsp_label = layers.data('nsp_label', shape=[1], dtype='int64')

    enc = bert_encoder(src, pos, sent, mask, cfg, is_test)
    # MLM head over all positions (dense path; gather of masked positions
    # is a host-side optimization)
    mlm_logits = layers.fc(enc, size=cfg.vocab_size, num_flatten_dims=2)
    mlm_loss = layers.softmax_with_cross_entropy(
        mlm_logits, layers.unsqueeze(mlm_label, [2]), ignore_index=-1)
    mlm_loss = layers.mean(mlm_loss)
    # NSP head on [CLS] (position 0)
    cls = layers.slice(enc, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [0, cfg.hidden])
    nsp_logits = layers.fc(cls, size=2)
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))
    loss = layers.elementwise_add(mlm_loss, nsp_loss)
    feeds = {'src_ids': src, 'pos_ids': pos, 'sent_ids': sent,
             'input_mask': mask, 'mlm_label': mlm_label,
             'nsp_label': nsp_label}
    return feeds, enc, loss


def synthetic_batch(cfg, batch, seq_len, rng):
    """A pretraining batch: random tokens, positions 0..T-1, sentence 0,
    no padding, ~15% of positions labelled for the MLM loss (-1
    elsewhere) and a random NSP label."""
    src = rng.randint(0, cfg.vocab_size, (batch, seq_len)).astype('int64')
    pos = np.tile(np.arange(seq_len), (batch, 1)).astype('int64')
    sent = np.zeros((batch, seq_len), 'int64')
    mask = np.ones((batch, seq_len), 'float32')
    mlm = np.where(rng.rand(batch, seq_len) < 0.15,
                   rng.randint(0, cfg.vocab_size, (batch, seq_len)),
                   -1).astype('int64')
    nsp = rng.randint(0, 2, (batch, 1)).astype('int64')
    return {'src_ids': src, 'pos_ids': pos, 'sent_ids': sent,
            'input_mask': mask, 'mlm_label': mlm, 'nsp_label': nsp}

"""Wide&Deep CTR model (BASELINE.json config 3), built with the port's
fluid layers into the same Program the JAX package builds
(models/wide_deep.py).

Reference workload: embedding_lookup_sparse + SelectedRows sparse
gradients (operators/lookup_table_op with is_sparse=True).  Here, as in
the JAX package, AdagradOptimizer turns each table's lookup gradient +
adagrad pair into one fused_emb_update over the looked-up rows, which
runs the hand-written sparse-row kernel on the GPU
(ops/kernels/embedding.py).
"""

import numpy as np

from .. import fluid
from ..fluid import layers


class WideDeepConfig(object):
    def __init__(self, sparse_feature_dim=1000, embedding_size=16,
                 num_sparse_fields=26, num_dense_fields=13,
                 hidden=(400, 400, 400)):
        self.sparse_feature_dim = sparse_feature_dim
        self.embedding_size = embedding_size
        self.num_sparse_fields = num_sparse_fields
        self.num_dense_fields = num_dense_fields
        self.hidden = hidden


BASE = WideDeepConfig()
TINY = WideDeepConfig(sparse_feature_dim=100, embedding_size=8,
                      num_sparse_fields=5, num_dense_fields=4,
                      hidden=(32, 16))


def build(cfg=None, is_sparse=True):
    cfg = cfg or BASE
    dense = fluid.layers.data('dense_input',
                              shape=[cfg.num_dense_fields],
                              dtype='float32')
    sparse = fluid.layers.data('sparse_input',
                               shape=[cfg.num_sparse_fields],
                               dtype='int64')
    label = fluid.layers.data('label', shape=[1], dtype='int64')

    # deep part: shared embedding table over all sparse fields
    emb = layers.embedding(
        sparse, size=[cfg.sparse_feature_dim, cfg.embedding_size],
        is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name='deep_embedding'))
    emb = layers.reshape(
        emb, [0, cfg.num_sparse_fields * cfg.embedding_size])
    deep = layers.concat([dense, emb], axis=1)
    for h in cfg.hidden:
        deep = layers.fc(deep, size=h, act='relu')

    # wide part: linear over one-hot sparse + dense
    wide_emb = layers.embedding(
        sparse, size=[cfg.sparse_feature_dim, 1], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name='wide_embedding'))
    wide = layers.reduce_sum(wide_emb, dim=1)
    wide_dense = layers.fc(dense, size=1, bias_attr=False)

    logit = layers.fc(deep, size=1)
    logit = layers.elementwise_add(logit, wide)
    logit = layers.elementwise_add(logit, wide_dense)

    label_f = layers.cast(label, 'float32')
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label_f))
    prob = layers.sigmoid(logit)
    # [1-p, p] for AUC
    preds = layers.concat([layers.elementwise_sub(
        layers.ones_like(prob), prob), prob], axis=1)
    feeds = {'dense_input': dense, 'sparse_input': sparse,
             'label': label}
    return feeds, preds, loss


def synthetic_batch(cfg, batch, rng):
    dense = rng.rand(batch, cfg.num_dense_fields).astype('float32')
    sparse = rng.randint(0, cfg.sparse_feature_dim,
                         (batch, cfg.num_sparse_fields)).astype('int64')
    # label correlated with features so training shows progress
    score = dense.sum(1) + (sparse.sum(1) % 7) * 0.1
    label = (score > np.median(score)).astype('int64')[:, None]
    return {'dense_input': dense, 'sparse_input': sparse,
            'label': label}

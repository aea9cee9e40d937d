"""Model builders of the port (reference: paddle_tpu/models): bert,
transformer, wide_deep, lenet, resnet, se_resnext and word2vec, each
imported by its module path."""

"""Model builders of the port (reference: paddle_tpu/models): bert,
transformer, wide_deep, lenet, resnet and se_resnext, each imported by
its module path."""

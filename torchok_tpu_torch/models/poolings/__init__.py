from torchok_tpu_torch.models.poolings.classification import linear, pooling  # noqa: F401

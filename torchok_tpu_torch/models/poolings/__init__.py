from torchok_tpu_torch.models.poolings.classification import pooling  # noqa: F401

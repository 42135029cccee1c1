from torchok_tpu_torch.models.heads.classification import classification_head  # noqa: F401

from torchok_tpu_torch.metrics import classification  # noqa: F401

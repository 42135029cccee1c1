from torchok_tpu_torch.tasks import classification  # noqa: F401

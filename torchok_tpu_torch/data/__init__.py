from torchok_tpu_torch.data import datasets, transforms  # noqa: F401

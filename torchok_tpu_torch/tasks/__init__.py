from torchok_tpu_torch.tasks import classification, segmentation  # noqa: F401

from torchok_tpu_torch.tasks import classification, detection, segmentation  # noqa: F401

from torchok_tpu_torch.models.necks.detection.fpn import FPN  # noqa: F401

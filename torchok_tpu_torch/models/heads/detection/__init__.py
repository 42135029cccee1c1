from torchok_tpu_torch.models.heads.detection.fcos import FCOSHead  # noqa: F401

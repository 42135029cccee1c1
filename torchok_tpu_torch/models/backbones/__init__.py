from torchok_tpu_torch.models.backbones import swin  # noqa: F401

from torchok_tpu_torch.models.backbones import davit, gcvit, swin  # noqa: F401

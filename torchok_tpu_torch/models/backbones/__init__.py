from torchok_tpu_torch.models.backbones import davit, gcvit, resnet, swin  # noqa: F401

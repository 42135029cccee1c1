from torchok_tpu_torch.models.backbones import (beit, davit, efficientnet, gcvit,  # noqa: F401
                                              hrnet, mobilenetv3, resnet, swin, vit)

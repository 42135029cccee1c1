from torchok_tpu_torch.models.backbones import (davit, efficientnet, gcvit, mobilenetv3,  # noqa: F401
                                              resnet, swin)

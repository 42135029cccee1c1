from torchok_tpu_torch.models.backbones import (davit, efficientnet, gcvit, hrnet,  # noqa: F401
                                              mobilenetv3, resnet, swin)

from torchok_tpu_torch.losses.detection.losses import (  # noqa: F401
    CrossEntropySigmoidLoss, FocalLoss, GIoULoss, IoULoss)

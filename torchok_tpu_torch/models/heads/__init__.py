from torchok_tpu_torch.models.heads.classification import (  # noqa: F401
    arcface_head, classification_head)
from torchok_tpu_torch.models.heads import segmentation  # noqa: F401
from torchok_tpu_torch.models.heads import detection  # noqa: F401
from torchok_tpu_torch.models.heads.representation import linear_head  # noqa: F401

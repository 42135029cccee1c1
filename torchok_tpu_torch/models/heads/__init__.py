from torchok_tpu_torch.models.heads.classification import (  # noqa: F401
    arcface_head, classification_head)

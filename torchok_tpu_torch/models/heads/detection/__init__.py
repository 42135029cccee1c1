from torchok_tpu_torch.models.heads.detection.fcos import FCOSHead  # noqa: F401
from torchok_tpu_torch.models.heads.detection.detr import DETRHead  # noqa: F401

from torchok_tpu_torch.models.necks.classification.hrnet import HRNetClassificationNeck  # noqa: F401
from torchok_tpu_torch.models.necks.segmentation.hrnet import HRNetSegmentationNeck  # noqa: F401
from torchok_tpu_torch.models.necks.detection.fpn import FPN  # noqa: F401

from torchok_tpu_torch.models.heads.segmentation.base import SegmentationHead  # noqa: F401

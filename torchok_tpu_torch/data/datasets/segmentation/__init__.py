from torchok_tpu_torch.data.datasets.segmentation.image_segmentation import (  # noqa: F401
    ImageSegmentationDataset,
)

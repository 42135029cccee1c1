from torchok_tpu_torch.data.datasets import classification, detection  # noqa: F401
from torchok_tpu_torch.data.datasets import representation, segmentation  # noqa: F401
from torchok_tpu_torch.data.datasets.examples import (  # noqa: F401
    cifar, coco, sop, sweet_pepper, synthetic)

from torchok_tpu_torch.data.datasets import classification, detection  # noqa: F401
from torchok_tpu_torch.data.datasets.examples import cifar, coco, synthetic  # noqa: F401

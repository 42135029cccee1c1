from torchok_tpu_torch.data.datasets.classification.classification import (  # noqa: F401
    ImageClassificationDataset)

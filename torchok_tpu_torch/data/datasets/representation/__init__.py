from torchok_tpu_torch.data.datasets.representation.unsupervised_contrastive_dataset import (  # noqa: F401
    UnsupervisedContrastiveDataset,
)
from torchok_tpu_torch.data.datasets.representation.validation import RetrievalDataset  # noqa: F401

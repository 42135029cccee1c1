from torchok_tpu_torch.losses.representation.pairwise import (  # noqa: F401
    BasePairwiseLoss, ContrastiveLoss, GeneralPairWeightingLoss,
)
from torchok_tpu_torch.losses.representation.unsupervised import NT_XentLoss  # noqa: F401

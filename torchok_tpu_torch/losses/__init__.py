from torchok_tpu_torch.losses.base import JointLoss  # noqa: F401
import torchok_tpu_torch.losses.common  # noqa: F401 — CrossEntropyLoss, the triplet losses
import torchok_tpu_torch.losses.segmentation  # noqa: F401 — registers DiceLoss
import torchok_tpu_torch.losses.detection  # noqa: F401 — registers the MM* detection losses
import torchok_tpu_torch.losses.representation  # noqa: F401 — ContrastiveLoss, NT_XentLoss

from torchok_tpu_torch.losses.base import JointLoss  # noqa: F401
import torchok_tpu_torch.losses.common  # noqa: F401 — registers CrossEntropyLoss

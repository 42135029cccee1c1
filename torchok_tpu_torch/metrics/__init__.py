from torchok_tpu_torch.metrics import classification  # noqa: F401
from torchok_tpu_torch.metrics import representation  # noqa: F401
from torchok_tpu_torch.metrics import representation_torchmetrics  # noqa: F401

import torchok_tpu_torch.callbacks.common  # noqa: F401
from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint  # noqa: F401

import torchok_tpu_torch.callbacks.common  # noqa: F401
import torchok_tpu_torch.callbacks.freeze_unfreeze  # noqa: F401
from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint  # noqa: F401
import torchok_tpu_torch.callbacks.checkpoint_stablehlo  # noqa: F401

import torchok_tpu_torch.optim.optimizers  # noqa: F401 — registers Adam, AdamW, SGD
import torchok_tpu_torch.optim.schedulers  # noqa: F401

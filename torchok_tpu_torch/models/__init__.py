from torchok_tpu_torch.models import backbones, heads, poolings  # noqa: F401

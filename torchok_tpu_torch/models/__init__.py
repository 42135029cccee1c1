from torchok_tpu_torch.models import backbones, heads, necks, poolings  # noqa: F401

from torchok_tpu_torch.losses.segmentation.dice import DiceLoss  # noqa: F401

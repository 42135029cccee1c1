from torchok_tpu_torch.data.datasets.examples import cifar, synthetic  # noqa: F401

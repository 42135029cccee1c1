from torchok_tpu_torch.data.datasets.examples import synthetic  # noqa: F401

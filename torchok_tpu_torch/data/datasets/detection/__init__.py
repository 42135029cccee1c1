from torchok_tpu_torch.data.datasets.detection.detection import DetectionDataset  # noqa: F401

from torchok_tpu_torch.tasks import classification, detection, segmentation  # noqa: F401
from torchok_tpu_torch.tasks import pairwise_task, simclr_task, triplet_task  # noqa: F401
from torchok_tpu_torch.tasks import stablehlo_task  # noqa: F401

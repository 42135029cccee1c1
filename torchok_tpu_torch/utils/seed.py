"""Global seeding (reference uses Lightning seed_everything)."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators. The port's own
    random state (model init, data) comes from explicit generators built
    from the same seed; this covers third-party code that reads the
    globals."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed

"""Synthetic classification dataset for benchmarks and offline smoke runs
(port of ``torchok_tpu.data.datasets.examples.synthetic``). The images come
from ``numpy.random.default_rng(seed)`` exactly as in ``torchok_tpu``, so both
packages see the same pixels and labels for the same seed; the shapes
dataset renders its patterns with the same numpy calls in the same order, so
its images, targets and masks equal ``torchok_tpu``'s bit for bit."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from torchok_tpu_torch.constructor import DATASETS
from torchok_tpu_torch.data.datasets.base import ImageDataset


@DATASETS.register_class
class SyntheticClassificationDataset(ImageDataset):
    uniform_image_size = True  # fixed-size in-memory arrays: vectorized batch fetch

    def __init__(self, transform, augment=None, num_samples: int = 10000,
                 image_size: Tuple[int, int] = (32, 32), channels: int = 3,
                 num_classes: int = 10, input_dtype: str = "float32",
                 test_mode: bool = False, seed: int = 0, **kwargs):
        super().__init__(transform=transform, augment=augment,
                         input_dtype=input_dtype, test_mode=test_mode)
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, size=(num_samples, *image_size, channels),
                                   dtype=np.uint8)
        self.targets = rng.integers(0, num_classes, size=(num_samples,)).astype(np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def get_batch(self, idxs: np.ndarray) -> dict:
        """Vectorized batch fetch (numpy fancy-index, no per-sample Python).
        Used by the loader when the host transform prefix is empty."""
        out = {"image": self.images[idxs], "index": idxs.astype("int64")}
        if not self.test_mode:
            out["target"] = self.targets[idxs]
        return out

    def __getitem__(self, idx: int) -> dict:
        sample = self.apply_host_pipeline({"image": self.images[idx]}, idx)
        out = {"image": sample["image"], "index": idx}
        if not self.test_mode:
            out["target"] = self.targets[idx]
        return out


@DATASETS.register_class
class SyntheticShapesDataset(ImageDataset):
    """Learnable procedural classification dataset (port of
    ``torchok_tpu``'s; it stands in for CIFAR-10 accuracy runs that must not
    download). Ten visually distinct pattern classes with randomized position,
    scale, colors and additive noise; train/val splits come from disjoint
    seeds of the same generator, so validation accuracy measures real
    generalization (chance = 10%).
    """
    uniform_image_size = True

    NUM_CLASSES = 10

    def __init__(self, transform, augment=None, num_samples: int = 10000,
                 image_size: Tuple[int, int] = (32, 32),
                 input_dtype: str = "float32", test_mode: bool = False,
                 train: bool = True, seed: int = 0, noise: float = 24.0,
                 hardness: float = 0.0, **kwargs):
        """``hardness`` in [0, 1] de-saturates accuracy ceilings (an accuracy
        pinned at 1.000 catches no regression). It overlaps the fg/bg contrast ranges, scales the
        additive noise, and with probability ``hardness`` adds a
        half-opacity distractor pattern of a *different* class plus a random
        occluding rectangle. Distractors/occlusions touch only the image,
        never the segmentation labels."""
        super().__init__(transform=transform, augment=augment,
                         input_dtype=input_dtype, test_mode=test_mode)
        rng = np.random.default_rng(seed + (0 if train else 10_000_019))
        h, w = image_size
        self.targets = rng.integers(0, self.NUM_CLASSES,
                                    size=(num_samples,)).astype(np.int64)
        self.images, self.masks = self._render(rng, self.targets, h, w, noise,
                                               hardness)

    @classmethod
    def _render(cls, rng, targets, h, w, noise, hardness=0.0):
        n = len(targets)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy = yy[None] / (h - 1)   # (1, h, w) in [0, 1]
        xx = xx[None] / (w - 1)

        # per-sample randomized geometry
        cy = rng.uniform(0.35, 0.65, size=(n, 1, 1)).astype(np.float32)
        cx = rng.uniform(0.35, 0.65, size=(n, 1, 1)).astype(np.float32)
        scale = rng.uniform(0.18, 0.30, size=(n, 1, 1)).astype(np.float32)
        freq = rng.integers(3, 6, size=(n, 1, 1)).astype(np.float32)
        phase = rng.uniform(0, 1, size=(n, 1, 1)).astype(np.float32)

        masks = cls._pattern_masks(targets, yy, xx, cy, cx, scale, freq,
                                   phase)
        fg_lo = 140.0 - 80.0 * hardness
        bg_hi = 110.0 + 80.0 * hardness
        fg = rng.uniform(fg_lo, 255, size=(n, 1, 1, 3)).astype(np.float32)
        bg = rng.uniform(0, bg_hi, size=(n, 1, 1, 3)).astype(np.float32)
        img = bg + masks[..., None] * (fg - bg)
        # per-pixel labels BEFORE distractors/occlusion: 0 = background,
        # class_id + 1 where the pattern is "on" (gradient thresholds at 0.5)
        seg = (masks > 0.5).astype(np.int64) * (targets[:, None, None] + 1)

        if hardness > 0:
            # half-opacity distractor of a DIFFERENT class, smaller scale
            d_targets = (targets + rng.integers(
                1, cls.NUM_CLASSES, size=targets.shape)) % cls.NUM_CLASSES
            d_cy = rng.uniform(0.2, 0.8, size=(n, 1, 1)).astype(np.float32)
            d_cx = rng.uniform(0.2, 0.8, size=(n, 1, 1)).astype(np.float32)
            d_scale = rng.uniform(0.10, 0.18, size=(n, 1, 1)).astype(np.float32)
            d_masks = cls._pattern_masks(d_targets, yy, xx, d_cy, d_cx,
                                         d_scale, freq, 1.0 - phase)
            # stripe/checker/gradient distractors confined to a local disc so
            # they distract rather than repaint the whole image
            rr = np.sqrt((yy - d_cy) ** 2 + (xx - d_cx) ** 2)
            d_masks = d_masks * (rr < d_scale * 1.8)
            d_on = (rng.uniform(size=(n, 1, 1)) < hardness).astype(np.float32)
            d_fg = rng.uniform(0, 255, size=(n, 1, 1, 3)).astype(np.float32)
            alpha = (0.5 * d_on * d_masks)[..., None]
            img = img * (1 - alpha) + d_fg * alpha

            # random occluding rectangle (noise-colored), up to ~35% width
            oy = rng.integers(0, h, size=(n, 1, 1))
            ox = rng.integers(0, w, size=(n, 1, 1))
            oh = rng.integers(2, max(3, int(h * 0.35)), size=(n, 1, 1))
            ow = rng.integers(2, max(3, int(w * 0.35)), size=(n, 1, 1))
            yy_i = np.mgrid[0:h, 0:w][0][None]
            xx_i = np.mgrid[0:h, 0:w][1][None]
            occ = ((yy_i >= oy) & (yy_i < oy + oh)
                   & (xx_i >= ox) & (xx_i < ox + ow))
            occ_on = (rng.uniform(size=(n, 1, 1)) < hardness)
            occ = (occ & occ_on)[..., None]
            occ_color = rng.uniform(0, 255, size=(n, 1, 1, 3)).astype(np.float32)
            img = np.where(occ, occ_color, img)
            noise = noise * (1.0 + 2.0 * hardness)

        img += rng.normal(0, noise, size=img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8), seg

    @staticmethod
    def _pattern_masks(targets, yy, xx, cy, cx, scale, freq, phase):
        masks = np.empty((len(targets),) + yy.shape[1:], np.float32)
        dy, dx = yy - cy, xx - cx
        r = np.sqrt(dy ** 2 + dx ** 2)
        ay, ax = np.abs(dy), np.abs(dx)
        t = targets
        masks[t == 0] = (r < scale)[t == 0]                              # disc
        masks[t == 1] = (np.maximum(ay, ax) < scale)[t == 1]             # square
        masks[t == 2] = (np.sin(2 * np.pi * (yy * freq + phase)) > 0)[t == 2]   # h-stripes
        masks[t == 3] = (np.sin(2 * np.pi * (xx * freq + phase)) > 0)[t == 3]   # v-stripes
        masks[t == 4] = ((np.sin(2 * np.pi * (xx * freq + phase)) > 0)
                         ^ (np.sin(2 * np.pi * (yy * freq + phase)) > 0))[t == 4]  # checker
        masks[t == 5] = ((xx + yy + phase) % 1.0)[t == 5]                # gradient
        masks[t == 6] = ((ay < scale * 0.4) | (ax < scale * 0.4))[t == 6]  # cross
        masks[t == 7] = ((dy > -scale) & (ax < (dy + scale) * 0.6))[t == 7]  # triangle
        masks[t == 8] = ((r < scale) & (r > scale * 0.55))[t == 8]       # ring
        masks[t == 9] = ((np.minimum(np.abs(dy - dx), np.abs(dy + dx))
                          < scale * 0.35) & (r < scale * 1.6))[t == 9]   # X
        return masks

    def __len__(self) -> int:
        return len(self.images)

    get_batch = SyntheticClassificationDataset.get_batch
    __getitem__ = SyntheticClassificationDataset.__getitem__

#!/usr/bin/env python3
"""Smoke run of torchok_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and the versions.
2. Builds the port's ten CUDA kernels from ``torchok_tpu_torch/csrc`` with
   nvcc, one compiler per source, side by side, and prints each kernel's
   registers and spills; for K1's bf16 tensor-core kernel
   (``csrc/swin_attention_fwd_mma.cuh``) and the two passes of the
   tensor-core backward (``csrc/swin_attention_bwd_mma.cuh``) in each of its
   instantiations (K2's cosine mode, K3b's plain local mode with and without
   a bias, K5's global-query mode) their registers and spill bytes, that
   ``cuobjdump -sass`` finds HMMA in each, and the route each window size
   takes per dtype (bf16 must take ``mma``, f32 the FMA kernels).
3. Holds each kernel against its plain PyTorch version on the card and times
   kernel, plain version and the closest library call
   (``F.scaled_dot_product_attention`` on prepared windows; for a backward
   kernel its forward + backward) with CUDA events (median after warm-up),
   beside the bound from the bytes each must move and the operations it does:
   * K1/K2 (SwinV2 cosine attention, forward/backward) at each stage shape of
     four SwinV2 models (``SWIN_MODELS``: windows 8; 16 and 8; 12 and 6; 24
     and 12, so L = 36 to 576; in f32, 576 on the key-tiled path), batch 8 in f32
     (TF32 off) and each model's batch (128; 32 at 384x384) in bf16. K1: max
     abs error <= 1e-4 in f32, <= 2e-2 in bf16. K2: dqkv, dbias and dscale
     each within a stated fraction of the reference's largest magnitude.
     Both bit-equal between two launches.
   * K3a/K3b (plain window attention, forward/backward) at gcvit_tiny's four
     local shapes (windows 7/7/14/7, with the bias) and davit_t's four
     (window 7, no bias); K4/K5 (global-query attention, forward/backward)
     at gcvit_tiny's four; batch 8 in f32 and batch 128 in bf16; then
     gcvit_tiny's four padded stage maps at the DETR recipe's 400x672
     (105x168, 56x84, 28x42, 14x21: non-square) at batch 8 in both dtypes,
     timed against the plain version, SDPA and the bound as well; the same
     tolerances, backward kernels bit-equal between two launches and on the
     route printed per shape (bf16 the tensor-core backward, f32 the FMA
     template), by the launches counted per route.
   * K6 (cosine attention on pre-partitioned head-major windows) at
     swinv2_tiny's four window shapes, masked and unmasked: f32 at batch 8
     <= 1e-4 (the FMA template), bf16 at batch 128 <= 2e-2 (one bf16 ulp of
     the largest output) and every output within one bf16 ulp of the plain
     version's (``outside_one_ulp``; the tensor-core kernel
     ``window_attention_mw_mma.cuh``, whose four kernels must hold HMMA in
     their SASS), with the route of each stage printed.
   * K7 (1x1-conv GEMM with the BatchNorm prologue and statistics) at
     ResNet-50's four stages in both directions at batch 256 in bf16 and
     batch 8 in f32, all four flag combinations at stage 4, one ragged M: y
     within 1e-4 (f32) or 2^-7 (bf16: one ulp) of the largest |y|; s1/s2
     within rtol 1e-4 plus an atol that grows with sqrt(M) (ulp flips and
     summation order are a random walk over the rows); bit-equal twice.
   * K8 (3x3 conv as an implicit GEMM) at ResNet-50's four 3x3 shapes at
     batch 256 in bf16 (its wgmma loop: the script first prints ``K8 SASS
     has HGMMA: true`` from ``cuobjdump -sass`` of the built library), batch
     8 in f32, odd sizes, a ragged M and Cout 64 and 512, same y tolerances,
     bit-equal twice; its library call is ``F.conv2d`` on channels-last bf16.
   * K9 (one inference MBConv block, fused) at the JAX probe's two shapes
     and EfficientNet-B0's nine blocks of its form (BatchNorms folded, eps
     1e-3), batch 8 in f32 (<= 1e-4 of the largest |y|; the three-launch
     route) and batch 256 in bf16 (<= two ulps; the one-launch cluster
     route of ``mbconv_fused_cluster.cuh``, whose four kernels must hold
     HMMA in their SASS), bit-equal between two launches, and in bf16 at
     B0's shapes of 2 to 8 strips with inputs whose output hangs on the SE
     mean across the strips (``make_se_case``); its library time is
     the unfused chain of library calls (``tools/probe_torch_mbconv_fused.py::
     library_block``) at the probe's shapes and the blocks' own eval forwards
     for the record.
4. Drives the four op paths at full width, counters zeroed before and read
   after: ``window_attention(..., use_kernel=True)`` forward and backward
   through the hybrid at swinv2_tiny's stage-1 shape (against the einsum
   formulation; the f32 launch on the FMA route, the bf16 one on the
   tensor cores); the 8-layer stage-4 bottleneck chain of
   ``tools/probe_torch_conv_bn.py`` forward and backward (8 K7 launches, no
   plain call, loss and gradients against the unfused chain); ``conv3x3_gemm``
   over the four shapes (against ``F.conv2d``); ``mbconv_fused`` over B0's
   nine blocks at batch 256 in bf16 (9 K9 launches, all by the cluster
   route, each within one bf16 ulp of the block's f32 eval forward).
5. Drives the slices through ``torchok_tpu_torch.__main__.run`` with the
   dicts below (each equal to its ``configs/classification_*_synthetic*.yaml``),
   at full width, batch 128 (ResNet-50, EfficientNet-B0, MobileNetV3: 256),
   bf16 autocast, random weights from the seed. The
   launch counters are zeroed just before each run and read just after; the
   counts must be exactly the expected kernel launches and no plain call:
   * inference (``SLICE_CONFIG`` swinv2_tiny 256x256, ``WINDOW16_SLICE_CONFIG``
     swinv2_tiny_window16 256x256, ``BASE384_SLICE_CONFIG``
     swinv2_base_window12to24 384x384 at batch 32, ``GCVIT_SLICE_CONFIG``
     gcvit_tiny 224x224), 3 batches in modes test and predict: 12 K1, 12 K1,
     24 K1 (22 at L = 576), or 17 K3a + 14 K4, per batch; finite logits,
     Accuracy and F1Score reported, and the model in f32 on the card within
     1e-3 of its CPU run (plain attention) on two images;
   * every registered SwinV2 variant (twelve) at batch 1 at its own input
     size: one K1 launch per block, no plain call, finite features;
   * training (``TRAIN_CONFIG``, ``WINDOW16_TRAIN_CONFIG``,
     ``GCVIT_TRAIN_CONFIG``, ``DAVIT_TRAIN_CONFIG`` with the train set cut to
     one batch repeated for 6 one-step epochs, one sanity and one final
     validation batch): per step 12 K1 + 12 K2 (both SwinV2s), or
     17 K3a + 14 K4 + 17 K3b + 14 K5, or 6 K3a + 6 K3b (davit_t), the K3b
     and K5 launches all on the tensor-core route; every loss
     finite and the last below the first; the validation metrics reported;
     every parameter finite and the named ones moved;
   * ResNet-50 (``RESNET_SLICE_CONFIG``, ``RESNET_TRAIN_CONFIG``, 224x224,
     batch 256) in modes test, predict and train the same way. The JAX ResNet
     reaches no Pallas kernel, so the port's reaches no hand-written kernel:
     every launch counter must stay at 0 through these runs. Its f32 logits
     on the card (cuDNN and matmul TF32 off) are held to 1e-3 of the CPU run's
     as the others are;
   * EfficientNet-B0 (``EFFNET_SLICE_CONFIG``, ``EFFNET_TRAIN_CONFIG``) in
     modes test, predict and train and MobileNetV3-large
     (``MNV3_SLICE_CONFIG``) in mode test, 224x224, batch 256, the same way:
     the JAX EfficientNet and MobileNetV3 reach no Pallas kernel, so every
     counter stays at 0;
   * one f32 forward + backward of swinv2_tiny (windows 8 and 16) and of
     gcvit_tiny on two images on the card (kernels) against the CPU (plain
     versions), over all parameter gradients, within 1e-3 of the largest
     gradient;
   * the classification north star ``configs/classification_shapes.yaml``
     (``SHAPES_RECIPE``) at its short budget (6 epochs, 8000 images;
     resnet18 at 32x32, ``steps_per_execution`` 16, CSVLogger,
     ModelCheckpoint, FinalizeLogger): valid/Accuracy >= 0.7573 - 0.03 at
     step 288, the reference's CSV rows, status ``success``, one best
     checkpoint and ``last.ckpt``, and ``+mode=test`` from the best
     checkpoint within 1e-3 of its logged accuracy; 0 hand-written launches;
   * ``configs/stablehlo_infer.yaml`` (``STABLEHLO_INFER_RECIPE``) through
     ``ONNXTask``: the shapes north star's best checkpoint exported with
     ``export_task_model`` and tested with the recipe's data and metrics on
     the shapes VALID images written as a CIFAR-10 test batch
     (``write_cifar_batches``); its Accuracy and F1Score equal to the live
     task's test on the same files to 1e-9. Then ``export_task_model`` on
     the swinv2_tiny slice's task must raise ``NotImplementedError`` naming
     K1 (its eval forward launches it);
   * resume on K1 and K2: swinv2_tiny's smoke train config for 3 one-step
     epochs twice, and for 2 then resumed from ``last.ckpt`` for the third;
     exact K1 and K2 counts in each run, and the resumed run's parameters
     and Adam moments bit-equal to the uninterrupted run's where the two
     uninterrupted runs are bit-equal (else no further from it than they
     are from each other, tensor by tensor);
   * the kNN index of the retrieval meters (``ops/knn.py``, no hand-written
     kernel: products and top-k in PyTorch, as the JAX package leaves them
     to XLA): ``FlatIndex`` on the card against f64 numpy on the host at
     the arcface recipe's 2000 x 128 (identical indexes, scores within
     1e-4, one gallery block and chunks merged on the card), duplicated
     vectors tied to the lower index, and ``IvfIndex`` on a 200k x 128
     clustered gallery with recall@1 >= 0.9 against the exact index; the
     search times;
   * the retrieval north star ``configs/representation_arcface_shapes.yaml``
     (``ARCFACE_RECIPE``) at its short budget (8 epochs, 8000 images;
     resnet18 + PoolingLinear + ArcFaceHead at 32x32, f32,
     ``steps_per_execution`` 16, 4 loader threads, CSVLogger,
     FinalizeLogger): valid/recall_at_1 >= 0.7255 - 0.05 at step 384,
     valid/recall_at_5 within the range RecallAtKMeter's semantics allow
     and within 1e-9 of a numpy count over the last epoch's embeddings,
     the meters' CSV columns, all 64 kNN searches on ``cuda``; 0
     hand-written launches;
   * HRNet-W18 with ``HRNetClassificationNeck``, pooling and head
     (``HRNET_SLICE_CONFIG``, ``HRNET_TRAIN_CONFIG``: bench.py's
     ``hrnet_w18_224_bs128``, 224x224, bs 128, bf16) in modes test, predict
     and train as the ResNet-50 slice runs, its f32 logits checked after
     ``unzero_and_calibrate``, and one f64 forward + backward on two images,
     card against CPU (each side's f32 gradients lie more than 1e-3 of the
     largest from f64 at its depth; both distances are printed); the JAX
     HRNet and neck reach no Pallas kernel, so every counter stays at 0;
   * the segmentation north star ``configs/segmentation_shapes.yaml``
     (``SEGMENTATION_RECIPE``) at its short budget (5 epochs, 8000 images;
     hrnet_w18_small + HRNetSegmentationNeck + SegmentationHead at 32x32,
     CrossEntropyLoss + DiceLoss, f32, ``steps_per_execution`` 8):
     valid/JaccardIndex >= 0.838 - 0.03 at step 280, the JaccardIndex of
     each epoch, train and eval img/s, peak memory, and the last
     validation's JaccardIndex recounted in numpy from the logits and labels
     the meter was given (``witness_jaccard``, to 1e-9); 0 hand-written
     launches;
   * the detection north star ``configs/detection_toy_fcos.yaml``
     (``FCOS_RECIPE``) at its short budget (8 epochs) from image files: the
     toy set of ``tools/gen_toy_detection.py`` written first without cv2 or
     pandas (``write_toy_detection``: the same draws, ``paint_rectangle``,
     a zlib PNG writer, a csv module ``ann.csv``), then resnet18 + FPN +
     FCOSHead at 96x96, bs 32, f32, the HorizontalFlip on the host, under
     ``trainer.deterministic=true`` (``FCOS_PHASE_OVERRIDES``: the recipe's
     training is chaotic and spikes now and then in both packages, so a run
     is one draw; ``CUBLAS_WORKSPACE_CONFIG`` is set as the script starts):
     valid/map50 >= 0.9772 - 0.05 at step 496, map50 by epoch, and the last
     validation's map50 recounted in numpy from the padded arrays the meter
     was given (``witness_map50``, to 1e-9); 0 hand-written launches;
   * the model of ``configs/detection/fcos_resnet50_coco.yaml`` at full
     width (``fcos_r50_config``: swsl_resnet50, FPN 256 from level 1 with
     two extra convs, FCOSHead of 80 classes, strides 8 to 128, nms_pre
     1000, max_per_img 100) on synthetic 400x672 PNGs, bs 8, bf16: 8 SGD
     steps with gradient clipping and one validation with MMDetectionMAP,
     the named parameters moved, then its f32 head outputs on the card
     within 1e-3 of the CPU's at every level; 0 hand-written launches;
   * ViT-S/16 and BEiT-B/16 (``VIT_SLICE_CONFIG``, ``VIT_TRAIN_CONFIG``,
     ``BEIT_SLICE_CONFIG``, ``BEIT_TRAIN_CONFIG``: bench.py's
     ``vit_small_224_bs128`` and ``beit_base_224_bs128``, 224x224, bs 128,
     bf16, no pooling) in modes test, predict and train as the ResNet-50
     slice runs, every parameter moved in training, one f32 forward +
     backward on two images card against CPU, and the SDPA backend of a
     bf16 train step from the profiler's ATen ops; the JAX ViT and BEiT
     reach no Pallas kernel, so every counter stays at 0;
   * the model of ``configs/detection/fcos_vit-s_coco.yaml`` at full width
     (``fcos_vit_config``: vit_small_patch16_224, FPN and FCOSHead as for
     ResNet-50; 400x672, bs 8, bf16, SGD with the recipe's ``paramwise_cfg``
     and clipping at 35) under the recipe's FreezeUnfreeze (``backbone``,
     ``stages: 1``) and ModelCheckpoint, through the COCO pipeline below:
     8 train steps, the sanity and one validation pass; the frozen set
     (patch_embed, pos_embed, cls_token, blocks.0), every frozen parameter on
     its decay-only SGD trajectory recomputed on the host (within 16 x 2^-24
     relative; one with no decay unchanged), every other parameter moved
     (but the backbone's unused final norm and a box scale of a level
     without positives), then its f32 head outputs on the card within 1e-3
     of the CPU's; 0 hand-written launches;
   * the DETR north star ``configs/detection_toy_detr.yaml``
     (``DETR_RECIPE``) at its short budget (100 epochs, T_max 100) on the
     same toy set: resnet18 + DETRHead (3 + 3 layers, 128 wide, 64 queries)
     at 96x96, bs 32, f32, ``steps_per_execution`` 4, AdamW with clipping
     at 0.1, the Hungarian assignment on the host (one copy of every
     layer's cost a step, scipy), with ``trainer.deterministic=true`` and two
     loader workers a loader (``DETR_PHASE_OVERRIDES``), from the port's own
     initial weights of draws 0, 1, 2, 3 and 7 (``DETR_DRAWS``), each in a
     process of its own (``--detr-recipe``) started before the build and
     running beside every later phase (so the kernel timings are taken
     beside them too): map50 at each of ten
     validations (step 6000, the recipe's decoding, 10 boxes an image),
     then one more validation decoded as the JAX head decodes inside a task
     (all 64 queries an image, as the reference's figure was counted); both
     last validations recounted in numpy (``witness_map50``, to 1e-9), the
     assignment's host ms a step, and the mean over the five draws of the
     reference-decoded map50 held to >= 0.2605 - 0.05; beside them a
     process (``--detr-determinism``) runs the task for 20 steps twice under
     ``trainer.deterministic=true`` (every parameter bit-equal, the tensors
     compared printed) and twice without; 0 hand-written launches;
   * the model of ``configs/detection/detr_gcvit-t_coco.yaml`` at full width
     (``detr_gcvit_config``: gcvit_tiny + DETRHead 6 + 6 layers, 256 wide,
     100 queries, 80 classes; 400x672, bs 8, bf16, AdamW with the recipe's
     ``paramwise_cfg``) through COCODetection, HorizontalFlip, FitResize,
     Normalize and PadIfNeeded from a synthetic COCO tree
     (``write_coco_tree``: PNGs of 300 to 800 a side, COCO's gapped
     category ids, ``iscrowd`` annotations): 8 train steps, the sanity and
     validation passes with MMDetectionMAP at 0.5 and 0.75 and CocoEvalMAP,
     exactly 17 K3a + 14 K4 a forward and 17 K3b + 14 K5 a step (all on the
     tensor cores), the named parameters moved, each parameter group's
     learning rate printed, then its f32 head outputs (every decoder
     layer's logits and boxes) on the card within 1e-3 of the CPU's;
   * in a process of their own (``chip_smoke.py --side-phases``,
     ``SIDE_PHASES``), started once the op paths are done and joined before
     the DETR draws (its output printed then), four phases. First the
     geometry of ``spatial.py`` (``run_spatial_recipe``): each of its
     device paths (``SPATIAL_DEVICE_CASES``: the affine, projective and
     distortion warps, the crops and resizes, the permutations, the pads)
     on 8 uint8 and float32 images of 256x256 and their masks on the card
     against the CPU under the same draws, equal where a case is exact and
     every mask, else within one uint8 level on 1% of the values and 1e-4
     in float32; then ``configs/classification_swinv2_tiny_spatial_aug_train.yaml``
     (``SPATIAL_TRAIN_CONFIG``): swinv2_tiny at full width, bf16, bs 64, 12
     steps on uint8 288x288 images whose whole TRAIN pipeline
     (RandomResizedCrop, HorizontalFlip, ShiftScaleRotate, Perspective,
     RandomRotate90, Normalize, ToTensorV2) runs in the device suffix (the
     split printed): 12 K1 a forward and 12 K2 a step, no plain call (the
     launches handed to the main process's kernels line), a finite loss,
     every parameter moved; then the host ms a sample of each new host
     transform at 256 to 400 px in a loader worker process, and no cv2, jax
     or torchok_tpu in that worker or this process; its seconds by part.
     Then the photometry of ``pixelwise.py``'s first half, Flip to ToSepia
     (``run_photometric_recipe``): each of the 27 names' device paths
     (``PHOTOMETRIC_DEVICE_CASES``: the tone and colour shifts, dropouts,
     casts, blurs, CLAHE, Equalize, HueSaturationValue, Downscale, Sharpen,
     ToSepia) on 8 uint8 and float32 images of 224x224 and their masks on
     the card against the CPU under the same draws, equal where the path's
     arithmetic rounds alike on both, else within one uint8 level on 1% of
     the values and 1e-4 in float32; then
     ``configs/classification_gcvit_tiny_photometric_aug_train.yaml``
     (``PHOTOMETRIC_TRAIN_CONFIG``): gcvit_tiny at full width, bf16, bs 64,
     12 steps on uint8 224x224 images whose whole TRAIN pipeline
     (RandomBrightnessContrast, HueSaturationValue, CLAHE, RandomGamma,
     GaussianBlur, MotionBlur, Sharpen, CoarseDropout, ToGray, Normalize,
     ToTensorV2) runs in the device suffix: 17 K3a and 14 K4 a forward, 17
     K3b and 14 K5 a step, all on the tensor cores, no plain call (the
     launches handed to the main process's kernels line through its
     ``photometric launches:`` line, as the spatial recipe's through its
     ``spatial launches:`` line), a finite loss, every parameter moved, the
     suffix's ms a batch; then the host ms a sample of each of the 27 host
     paths at 224x224 in a loader worker process (a JPEG round trip timed,
     or its error naming libjpeg printed), and no cv2, jax or torchok_tpu
     in that worker or this process; its seconds by part.
     Then ``configs/segmentation_sweet_pepper.yaml``
     (``SWEET_PEPPER_RECIPE``) verbatim but for its cuts: its TRAIN
     pipeline (flips, Compose(p 0.5) of PadIfNeeded and CenterCrop, two
     OneOf(p 1) over ElasticTransform, GridDistortion, GaussNoise and
     ColorJitter, then Resize, Normalize and ToTensorV2), hrnet_w18 +
     HRNetSegmentationNeck + SegmentationHead (3 classes, 256x256, bs 8,
     f32, CE + Dice) and ModelCheckpointWithOnnx, reading ``SweetPepper``
     from PNG images and gray PNG masks with ``train.csv`` and
     ``valid.csv`` that the script writes (``write_sweet_pepper_tree``), in
     4 loader worker processes, one epoch of 40 steps and a validation
     (random weights, CSVLogger; the cuts printed): first each new device
     path on a card batch against its CPU path with the same draws, the
     host ms a sample of each transform, then a finite loss, every
     parameter moved, no cv2, jax or torchok_tpu in this process or a
     loader worker, train img/s, peak memory, and an artifact beside each
     checkpoint, replaying the VALID images at batch 64 (and the first 8 at
     batch 1) within 1e-5 of the live eval forward's largest magnitude
     (``check_artifacts``); 0 hand-written launches;
   * then the three SOP recipes at full width (``PAIRWISE_SOP_RECIPE``:
     resnet18 224x224, bs 64, LinearHead 512 normalised, ContrastiveLoss
     over the relevance of 11318 classes; ``TRIPLET_SOP_RECIPE``: bs 4
     triplets, TripletMarginLoss; ``ARCFACE_SOP_RECIPE``: semnasnet_100
     256x256, bs 64, PoolingLinear, ArcFaceHead of 11318 classes,
     FreezeUnfreeze, ModelCheckpointWithOnnx), each equal to its YAML but
     for its cuts (random weights, the data folder, one epoch of
     ``SOP_LIMIT_TRAIN`` steps, CSVLogger), on a SOP tree the script writes
     (``write_sop_tree``: PNGs of 200 to 400 px with class-dependent
     stripes, SOP's three ``.txt`` files with its label offsets): finite
     losses; every parameter that trains moved (under arcface_sop's
     epoch-0 policy the frozen backbone on its decay-only Nesterov SGD
     trajectory, its BatchNorm statistics bit-equal); HitAtKMeter equal to
     a numpy recount (f64 inner products, no shared search) to 1e-9 on the
     run's embeddings where f32 resolves their directions (arcface's
     random frozen backbone gives one direction: its reading is printed)
     and on them centred (``check_hit``), and arcface's train Accuracy on
     the run's logits and again with half their targets planted at the
     argmax (the run's own reading is 0); an
     artifact beside every checkpoint (the script exports those of the two
     recipes whose plain ModelCheckpoint writes none), each replayed as
     above; train and eval img/s, peak memory, seconds per export and the
     largest replay difference; 0 hand-written launches.
   Each phase is stamped with the script's seconds so far.
6. Prints ``{"kernels": [...]}`` (K1 to K9; K1/K2's times are summed over
   one swinv2_tiny_window8 forward or backward, as before the other windows ran, the K3 to K5 times
   over one gcvit_tiny forward or backward, K6's over one swinv2_tiny forward,
   K7's over the chain's forward, K8's over its four shapes, K9's over B0's
   nine blocks), the script's seconds, the card line,
   and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without the last line. Without a CUDA
device, or without the package beside this script, it exits 1 at once.
"""
from __future__ import annotations

import atexit
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

_METRIC = {"params": {"task": "multiclass", "num_classes": 1000},
           "mapping": {"preds": "prediction", "target": "target"}}


def _synthetic(num_samples, shuffle, drop_last, size=256, batch=128, **extra):
    return [{
        "dataloader": {"batch_size": batch, "num_workers": 2, "drop_last": drop_last,
                       "shuffle": shuffle},
        "dataset": {
            "name": "SyntheticClassificationDataset",
            "params": {"num_samples": num_samples, "num_classes": 1000,
                       "image_size": [size, size], **extra},
            "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}],
        },
    }]


def _task(backbone, size, neck=None, pooling="Pooling", **backbone_params):
    task = {
        "name": "ClassificationTask",
        "params": {
            "backbone_name": backbone,
            "backbone_params": {"pretrained": False, "in_channels": 3, **backbone_params},
            # a ViT or BEiT head takes the backbone's cls token: no pooling
            **({"pooling_name": pooling} if pooling else {}),
            "head_name": "ClassificationHead",
            "head_params": {"num_classes": 1000},
            "inputs": [{"shape": [3, size, size], "dtype": "float32"}],
        },
    }
    if neck is not None:
        task["params"]["neck_name"] = neck
    return task


def slice_config(backbone, size, batch=128, neck=None, pooling="Pooling", **backbone_params):
    """The inference recipe (configs/classification_<model>_synthetic.yaml)."""
    data = _synthetic(3 * batch, False, False, size, batch)
    return {
        "task": _task(backbone, size, neck, pooling, **backbone_params),
        "data": {"TEST": data, "PREDICT": data},
        "trainer": {"accelerator": "gpu", "precision": 16,
                    "limit_test_batches": 3, "limit_predict_batches": 3},
        "seed_params": {"seed": 42},
        "metrics": [{"name": "Accuracy", **_METRIC}, {"name": "F1Score", **_METRIC}],
    }


def train_config(backbone, size, batch=128, neck=None, pooling="Pooling", **backbone_params):
    """The train recipe (configs/classification_<model>_synthetic_train.yaml)."""
    return {
        "task": _task(backbone, size, neck, pooling, **backbone_params),
        "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                                   "mapping": {"input": "prediction", "target": "target"}}]},
        "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}}}],
        "data": {"TRAIN": _synthetic(10 * batch, True, True, size, batch),
                 "VALID": _synthetic(2 * batch, False, False, size, batch, seed=1)},
        "trainer": {"accelerator": "gpu", "precision": 16, "max_epochs": 2},
        "seed_params": {"seed": 42},
        "metrics": [{"name": "Accuracy", **_METRIC}],
    }


SLICE_CONFIG = slice_config("swinv2_tiny_window8_256", 256)
TRAIN_CONFIG = train_config("swinv2_tiny_window8_256", 256)
WINDOW16_SLICE_CONFIG = slice_config("swinv2_tiny_window16_256", 256)
WINDOW16_TRAIN_CONFIG = train_config("swinv2_tiny_window16_256", 256)
BASE384_SLICE_CONFIG = slice_config("swinv2_base_window12to24_192to384_22kft1k", 384, batch=32)
GCVIT_SLICE_CONFIG = slice_config("gcvit_tiny", 224, img_size=224)
GCVIT_TRAIN_CONFIG = train_config("gcvit_tiny", 224, img_size=224)
DAVIT_TRAIN_CONFIG = train_config("davit_t", 224)
RESNET_SLICE_CONFIG = slice_config("resnet50", 224, batch=256)
RESNET_TRAIN_CONFIG = train_config("resnet50", 224, batch=256)
EFFNET_SLICE_CONFIG = slice_config("efficientnet_b0", 224, batch=256)
EFFNET_TRAIN_CONFIG = train_config("efficientnet_b0", 224, batch=256)
MNV3_SLICE_CONFIG = slice_config("mobilenetv3_large_100", 224, batch=256)
# bench.py's hrnet_w18_224_bs128 case: HRNet-W18 with HRNetClassificationNeck
HRNET_SLICE_CONFIG = slice_config("hrnet_w18", 224, neck="HRNetClassificationNeck")
HRNET_TRAIN_CONFIG = train_config("hrnet_w18", 224, neck="HRNetClassificationNeck")
# bench.py's vit_small_224_bs128 and beit_base_224_bs128: no pooling
VIT_SLICE_CONFIG = slice_config("vit_small_patch16_224", 224, pooling=None)
VIT_TRAIN_CONFIG = train_config("vit_small_patch16_224", 224, pooling=None)
BEIT_SLICE_CONFIG = slice_config("beit_base_patch16_224", 224, pooling=None)
BEIT_TRAIN_CONFIG = train_config("beit_base_patch16_224", 224, pooling=None)

_SHAPES_TRANSFORM = [{"name": "Resize", "params": {"height": 32, "width": 32}},
                     {"name": "Normalize", "params": {"mean": [0.485, 0.456, 0.406],
                                                      "std": [0.229, 0.224, 0.225]}},
                     {"name": "ToTensorV2"}]
_SHAPES_METRIC = {"params": {"task": "multiclass", "num_classes": 10},
                  "mapping": {"preds": "prediction", "target": "target"}}


def _shapes_data(train, num_samples):
    return [{"dataloader": {"batch_size": 128, "num_workers": 8, "drop_last": train,
                            "shuffle": train},
             "dataset": {"name": "SyntheticShapesDataset",
                         "params": {"hardness": 0.6, "input_dtype": "float16", "train": train,
                                    "num_samples": num_samples},
                         "transform": copy.deepcopy(_SHAPES_TRANSFORM)}}]


# configs/classification_shapes.yaml, the classification north star (a CPU
# test holds the two equal)
SHAPES_RECIPE = {
    "task": {"name": "ClassificationTask",
             "params": {"backbone_name": "resnet18",
                        "backbone_params": {"pretrained": False, "in_channels": 3},
                        "pooling_name": "Pooling", "head_name": "ClassificationHead",
                        "head_params": {"num_classes": 10},
                        "inputs": [{"shape": [3, 32, 32], "dtype": "float16"}]}},
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}},
                      "scheduler": {"name": "ExponentialLR", "params": {"gamma": 0.97}}}],
    "data": {"TRAIN": _shapes_data(True, 20000), "VALID": _shapes_data(False, 4000)},
    "trainer": {"accelerator": "auto", "max_epochs": 30, "precision": 16,
                "num_sanity_val_steps": 0, "steps_per_execution": 16},
    "seed_params": {"seed": 42, "workers": True},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/shapes/logs",
               "experiment_name": "resnet18", "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}",
               "name": "CSVLogger"},
    "callbacks": [{"name": "ModelCheckpoint",
                   "params": {"monitor": "valid/F1Score", "save_top_k": 1, "save_last": True,
                              "mode": "max", "save_weights_only": False}},
                  {"name": "FinalizeLogger"}],
    "metrics": [{"name": "Accuracy", **_SHAPES_METRIC}, {"name": "F1Score", **_SHAPES_METRIC}],
}
_ARCFACE_TRANSFORM = [{"name": "Resize", "params": {"height": 32, "width": 32}},
                      {"name": "Normalize"}, {"name": "ToTensorV2"}]
_ARCFACE_METER = {"params": {"dataset_type": "classification", "normalize_vectors": True},
                  "mapping": {"vectors": "embeddings", "group_labels": "target"},
                  "phases": ["VALID"]}


def _arcface_data(train, num_samples):
    data = {"dataloader": {"batch_size": 128, "num_workers": 4, "drop_last": train,
                           "shuffle": train},
            "dataset": {"name": "SyntheticShapesDataset",
                        "params": {"hardness": 0.4, "input_dtype": "float32", "train": train,
                                   "num_samples": num_samples},
                        "transform": copy.deepcopy(_ARCFACE_TRANSFORM)}}
    if train:
        data["dataset"]["augment"] = [{"name": "HorizontalFlip"}]
    return [data]


def _arcface_meter(name, tag, k):
    meter = copy.deepcopy(_ARCFACE_METER)
    meter["params"] = {"k": k, **meter["params"]}
    return {"name": name, "tag": tag, **meter}


# configs/representation_arcface_shapes.yaml, the retrieval north star (a CPU
# test holds the two equal)
ARCFACE_RECIPE = {
    "task": {"name": "ClassificationTask", "compute_loss_on_valid": False,
             "params": {"backbone_name": "resnet18",
                        "backbone_params": {"pretrained": False, "in_channels": 3},
                        "pooling_name": "PoolingLinear", "pooling_params": {"out_channels": 128},
                        "head_name": "ArcFaceHead", "head_params": {"num_classes": 10},
                        "inputs": [{"shape": [3, 32, 32], "dtype": "float32"}]}},
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "SGD",
                                    "params": {"lr": 0.01, "momentum": 0.9, "nesterov": True,
                                               "weight_decay": 0.00005}},
                      "scheduler": {"name": "CosineAnnealingLR", "params": {"T_max": 30}}}],
    "data": {"TRAIN": _arcface_data(True, 20000), "VALID": _arcface_data(False, 2000)},
    "trainer": {"accelerator": "auto", "max_epochs": 30, "precision": 32,
                "num_sanity_val_steps": 0, "steps_per_execution": 16},
    "seed_params": {"seed": 42},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/shapes_arcface/logs",
               "experiment_name": "resnet18_arcface",
               "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}", "name": "CSVLogger"},
    "callbacks": [{"name": "FinalizeLogger"}],
    "metrics": [_arcface_meter("HitAtKMeter", "recall_at_1", 1),
                _arcface_meter("RecallAtKMeter", "recall_at_5", 5),
                {"name": "Accuracy", "params": {"task": "multiclass", "num_classes": 10},
                 "mapping": {"preds": "prediction", "target": "target"}, "phases": ["TRAIN"]}],
}
# the short budget of tools/north_star_baselines.json ("arcface"), held
# one-sided to valid/recall_at_1 >= 0.7255 - 0.05 as tools/check_north_stars.py does
ARCFACE_OVERRIDES = ["trainer.max_epochs=8", "data.TRAIN.0.dataset.params.num_samples=8000"]
ARCFACE_REFERENCE = 0.7255
ARCFACE_TOLERANCE = 0.05
# drop_last takes the super-batch of 16 x 128: 8000 // 2048 = 3 executions an
# epoch (torchok_tpu's fit serves K x B super-batches, engine/trainer.py:694)
ARCFACE_STEPS = 8 * 3 * 16
ARCFACE_CSV_HEADER = ["step", "train/loss", "train/Accuracy", "train/epoch_time_s",
                      "train/images_per_sec", "valid/recall_at_1", "valid/recall_at_5", "lr"]

# the short budget of tools/north_star_baselines.json ("classification"), held
# one-sided to valid/Accuracy >= 0.7573 - 0.03 as tools/check_north_stars.py does
SHAPES_OVERRIDES = ["trainer.max_epochs=6", "data.TRAIN.0.dataset.params.num_samples=8000"]
SHAPES_REFERENCE = 0.7573
SHAPES_TOLERANCE = 0.03
# drop_last takes the super-batch of 16 x 128: 8000 // 2048 = 3 executions an epoch
SHAPES_STEPS = 6 * 3 * 16
# metrics.csv's rows: the epoch logs at each epoch's last step and the train
# loss where the step count passes a multiple of log_every_n_steps (50)
# between executions of 16 steps
SHAPES_CSV_STEPS = [48, 64, 96, 112, 144, 160, 192, 208, 240, 256, 288]
SHAPES_CSV_HEADER = ["step", "train/loss", "train/Accuracy", "train/F1Score",
                     "train/epoch_time_s", "train/images_per_sec", "valid/loss",
                     "valid/Accuracy", "valid/F1Score", "lr"]


def _with_overrides(recipe: dict, overrides, log_dir: str) -> dict:
    """``recipe`` with a short budget's ``overrides``, logging under ``log_dir``."""
    from torchok_tpu_torch.constructor.config import apply_override
    cfg = copy.deepcopy(recipe)
    for override in overrides:
        key, _, value = override.partition("=")
        apply_override(cfg, key, value)
    cfg["logger"]["log_dir"] = log_dir
    return cfg


def shapes_config(log_dir: str) -> dict:
    """The shapes recipe with the short budget's overrides, logging under
    ``log_dir``."""
    return _with_overrides(SHAPES_RECIPE, SHAPES_OVERRIDES, log_dir)


def arcface_config(log_dir: str) -> dict:
    """The arcface recipe with the short budget's overrides, logging under
    ``log_dir``."""
    return _with_overrides(ARCFACE_RECIPE, ARCFACE_OVERRIDES, log_dir)


_SEGMENTATION_TRANSFORM = [{"name": "Resize", "params": {"height": 32, "width": 32}},
                           {"name": "Normalize"}, {"name": "ToTensorV2"}]


def _segmentation_data(train, num_samples):
    return [{"dataloader": {"batch_size": 128, "num_workers": 4, "drop_last": train,
                            "shuffle": train},
             "dataset": {"name": "SyntheticShapesSegmentationDataset",
                         "params": {"input_dtype": "float32", "train": train,
                                    "num_samples": num_samples},
                         "transform": copy.deepcopy(_SEGMENTATION_TRANSFORM)}}]


def _segmentation_loss(name, tag, weight, **params):
    loss = {"name": name, "tag": tag, "weight": weight,
            "mapping": {"input": "prediction", "target": "target"}}
    return {**loss, "params": params} if params else loss


# configs/segmentation_shapes.yaml, the segmentation north star (a CPU test
# holds the two equal)
SEGMENTATION_RECIPE = {
    "task": {"name": "SegmentationTask",
             "params": {"backbone_name": "hrnet_w18_small",
                        "backbone_params": {"pretrained": False, "in_channels": 3},
                        "neck_name": "HRNetSegmentationNeck",
                        "head_name": "SegmentationHead", "head_params": {"num_classes": 11},
                        "inputs": [{"shape": [3, 32, 32], "dtype": "float32"}]}},
    "joint_loss": {"losses": [_segmentation_loss("CrossEntropyLoss", "ce", 0.6),
                              _segmentation_loss("DiceLoss", "dice", 0.4, mode="multiclass")]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.001}},
                      "scheduler": {"name": "ExponentialLR", "params": {"gamma": 0.95}}}],
    "data": {"TRAIN": _segmentation_data(True, 20000),
             "VALID": _segmentation_data(False, 2000)},
    "trainer": {"accelerator": "auto", "max_epochs": 15, "precision": 32,
                "num_sanity_val_steps": 0, "steps_per_execution": 8},
    "seed_params": {"seed": 42},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/shapes_seg/logs",
               "experiment_name": "hrnet_w18_small",
               "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}", "name": "CSVLogger"},
    "callbacks": [{"name": "FinalizeLogger"}],
    "metrics": [{"name": "JaccardIndex", "params": {"num_classes": 11, "ignore_index": 0},
                 "mapping": {"preds": "prediction", "target": "target"},
                 "phases": ["VALID"]}],
}
# the short budget of tools/north_star_baselines.json ("segmentation"), held
# one-sided to valid/JaccardIndex >= 0.838 - 0.03 as tools/check_north_stars.py does
SEGMENTATION_OVERRIDES = ["trainer.max_epochs=5", "data.TRAIN.0.dataset.params.num_samples=8000"]
SEGMENTATION_REFERENCE = 0.838
SEGMENTATION_TOLERANCE = 0.03
# drop_last takes the super-batch of 8 x 128: 8000 // 1024 = 7 executions an epoch
SEGMENTATION_STEPS = 5 * 7 * 8


def segmentation_config(log_dir: str) -> dict:
    """The segmentation recipe with the short budget's overrides, logging
    under ``log_dir``."""
    return _with_overrides(SEGMENTATION_RECIPE, SEGMENTATION_OVERRIDES, log_dir)


def _fcos_loss(name, tag, mapping, **params):
    loss = {"name": name, "tag": tag, "mapping": mapping}
    return {**loss, "params": params} if params else loss


# the three losses and their mappings of both FCOS recipes
FCOS_LOSSES = [
    _fcos_loss("MMFocalLoss", "loss_cls", {"pred": "flatten_cls_scores",
                                           "target": "flatten_labels", "avg_factor": "num_pos"},
               use_sigmoid=True, gamma=2.0, alpha=0.25),
    _fcos_loss("MMIoULoss", "loss_bbox", {"pred": "pos_decoded_bbox_preds",
                                          "target": "pos_decoded_target_preds",
                                          "weight": "pos_centerness_targets",
                                          "avg_factor": "centerness_denorm"}),
    _fcos_loss("MMCrossEntropyLoss", "loss_centerness", {"cls_score": "pos_centerness",
                                                         "label": "pos_centerness_targets",
                                                         "avg_factor": "num_pos"},
               use_sigmoid=True),
]


def _toydet_data(split, train):
    dataset = {"name": "DetectionDataset",
               "params": {"data_folder": f"${{oc.env:HOME}}/.cache/torchok_tpu/toydet/{split}",
                          "annotation_path": "ann.csv", "bbox_format": "coco", "max_boxes": 4,
                          "input_dtype": "float32"},
               "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}
    loader = {"batch_size": 32, "num_workers": 4}
    if train:
        dataset["augment"] = [{"name": "HorizontalFlip"}]
        loader.update(drop_last=True, shuffle=True)
    return [{"dataloader": loader, "dataset": dataset}]


# configs/detection_toy_fcos.yaml, the detection north star (a CPU test holds
# the two equal)
FCOS_RECIPE = {
    "task": {"name": "SingleStageDetectionTask",
             "params": {"backbone_name": "resnet18",
                        "backbone_params": {"pretrained": False, "in_channels": 3},
                        "num_scales": 3, "neck_name": "FPN",
                        "neck_params": {"out_channels": 64, "num_outs": 3},
                        "head_name": "FCOSHead",
                        "head_params": {"num_classes": 2, "strides": [8, 16, 32],
                                        "feat_channels": 64, "stacked_convs": 2,
                                        "test_cfg": {"nms_pre": 100, "score_thr": 0.05,
                                                     "nms": {"iou_threshold": 0.6},
                                                     "max_per_img": 10}},
                        "inputs": [{"shape": [3, 96, 96], "dtype": "float32"}]}},
    "joint_loss": {"normalize_weights": False, "losses": copy.deepcopy(FCOS_LOSSES)},
    "optimization": [{"optimizer": {"name": "SGD", "params": {"lr": 0.01, "momentum": 0.9}},
                      "scheduler": {"name": "CosineAnnealingLR", "params": {"T_max": 20}}}],
    "data": {"TRAIN": _toydet_data("train", True), "VALID": _toydet_data("valid", False)},
    "trainer": {"max_epochs": 20, "precision": 32, "num_sanity_val_steps": 0},
    "seed_params": {"seed": 7},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/toydet/logs",
               "experiment_name": "fcos_resnet18",
               "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}", "name": "CSVLogger"},
    "callbacks": [{"name": "FinalizeLogger"}],
    "metrics": [{"name": "MMDetectionMAP", "tag": "map50",
                 "params": {"iou_thr": 0.5, "num_classes": 2},
                 "mapping": {"preds": "prediction", "target": "target"}, "phases": ["VALID"]}],
}
# the short budget of tools/north_star_baselines.json ("fcos"), held one-sided
# to valid/map50 >= 0.9772 - 0.05 as tools/check_north_stars.py does
FCOS_OVERRIDES = ["trainer.max_epochs=8"]
# the smoke's runs: reproducible. The recipe's training is chaotic (two fits
# from one start over the same batches part by rounding, 2e-7 in the first
# loss, growing 30 to 60 times a step) and SGD at lr 0.01 with no warm-up or
# clipping spikes now and then, in the JAX package as in the port
# (tools/compare_fcos_fit_jax.py, tools/fcos_trajectories_cpu.py): an epoch's
# map50 can fall to 0.33 to 0.84 and recover, and where that falls on the
# last epoch (0.769698 once on the card) the gate fails. Under the mode the
# smoke reads one draw, map50 by epoch [0.889896, 0.949283, 0.913251,
# 0.965117, 0.549846, 0.965321, 0.973471, 0.97469]: its dip at epoch 4 lies
# in the weights (tools/probe_fcos_dip.py), which both packages validate to
# the same 0.5498460073157077 (tools/compare_fcos_dip_jax.py)
FCOS_PHASE_OVERRIDES = ["+trainer.deterministic=true"]
FCOS_REFERENCE = 0.9772
FCOS_TOLERANCE = 0.05
# tools/gen_toy_detection.py's two splits: (split, images, seed)
TOYDET_SPLITS = (("train", 2000, 1), ("valid", 400, 2))
# drop_last: 2000 // 32 = 62 steps an epoch
FCOS_STEPS = 8 * 62


def fcos_config(data_root: str, log_dir: str) -> dict:
    """The FCOS recipe with the short budget's overrides, reading the toy
    set under ``data_root`` and logging under ``log_dir``."""
    overrides = FCOS_OVERRIDES + [f"data.{phase}.0.dataset.params.data_folder="
                                  f"{os.path.join(data_root, split)}"
                                  for phase, split in (("TRAIN", "train"), ("VALID", "valid"))]
    return _with_overrides(FCOS_RECIPE, overrides, log_dir)


def paint_rectangle(img, x0, y0, x1, y1, value, thickness):
    """``cv2.rectangle(img, (x0, y0), (x1, y1), (value,) * 3, thickness)`` of
    OpenCV's default 8-connected line, for the two thicknesses the toy set
    draws: -1 fills the corners' box inclusively; 3 draws each edge 5 pixels
    wide (2 either side) with the outer corners rounded to a radius-2
    disc, as cv2 draws a thick line's round caps."""
    import numpy as np
    h, w = img.shape[:2]
    ys, xs = np.ogrid[:h, :w]
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    if thickness == -1:
        mask = inside
    elif thickness == 3:
        over_x = np.maximum(np.maximum(x0 - xs, xs - x1), 0)
        over_y = np.maximum(np.maximum(y0 - ys, ys - y1), 0)
        hole = (xs > x0 + 2) & (xs < x1 - 2) & (ys > y0 + 2) & (ys < y1 - 2)
        mask = (over_x ** 2 + over_y ** 2 <= 4) & ~hole
    else:
        raise ValueError(f"thickness {thickness}: only -1 and 3 are drawn")
    img[mask] = value


def write_toy_detection(root, split, n, seed):
    """``tools/gen_toy_detection.py``'s ``gen(split, n, seed)`` without cv2 or
    pandas: the same draws from ``np.random.default_rng(seed)``, filled
    rectangles (class 0) and rings of thickness 3 (class 1) painted by
    :func:`paint_rectangle`, each image written as cv2.imwrite writes it (the
    array read as BGR) by a PNG writer on ``zlib``, and ``ann.csv`` with the
    COCO boxes and labels as JSON lists. Returns the image count."""
    import csv
    import json
    import numpy as np
    from torchok_tpu_torch.native import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        img = rng.integers(0, 70, size=(96, 96, 3), dtype=np.uint8)
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, 4))):
            w, h = int(rng.integers(16, 36)), int(rng.integers(16, 36))
            x0 = int(rng.integers(2, 94 - w))
            y0 = int(rng.integers(2, 94 - h))
            cls = int(rng.integers(0, 2))
            value = int(rng.integers(160, 255))
            paint_rectangle(img, x0, y0, x0 + w, y0 + h, value, -1 if cls == 0 else 3)
            boxes.append([x0, y0, w, h])
            labels.append(cls)
        name = f"{split}_{i}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(img[..., ::-1]))
        rows.append({"image_path": name, "bbox": json.dumps(boxes), "label": json.dumps(labels)})
    with open(os.path.join(root, "ann.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["image_path", "bbox", "label"])
        writer.writeheader()
        writer.writerows(rows)
    return n


# configs/detection/fcos_resnet50_coco.yaml's model at full width on synthetic
# 400x672 images (COCO waits for its files): pretrained off, no paramwise_cfg
# (queue 1 item 13), no FitResize or PadIfNeeded (item 12: the images already
# have the input size), one epoch of FCOS_R50_TRAIN images and one
# validation over FCOS_R50_VALID
FCOS_R50_SIZE = (400, 672)
FCOS_R50_TRAIN, FCOS_R50_VALID = 64, 16
FCOS_R50_STEPS = FCOS_R50_TRAIN // 8


def _r50_data(root, train):
    dataset = {"name": "DetectionDataset",
               "params": {"data_folder": root, "annotation_path": "ann.csv",
                          "bbox_format": "coco", "input_dtype": "float16",
                          "bbox_dtype": "float32", "image_format": "rgb"},
               "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}
    if train:
        dataset["augment"] = [{"name": "HorizontalFlip"}]
    return [{"dataloader": {"batch_size": 8, "num_workers": 8, "drop_last": False,
                            "shuffle": train},
             "dataset": dataset}]


def fcos_r50_config(data_root: str) -> dict:
    return {
        "task": {"name": "SingleStageDetectionTask",
                 "params": {"backbone_name": "swsl_resnet50",
                            "backbone_params": {"pretrained": False, "in_channels": 3},
                            "num_scales": 4, "neck_name": "FPN",
                            "neck_params": {"out_channels": 256, "start_level": 1,
                                            "add_extra_convs": "on_output", "num_outs": 5,
                                            "relu_before_extra_convs": True},
                            "head_name": "FCOSHead",
                            "head_params": {
                                "num_classes": 80, "strides": [8, 16, 32, 64, 128],
                                "feat_channels": 256, "stacked_convs": 4,
                                "train_cfg": {"assigner": {"type": "MaxIoUAssigner",
                                                           "pos_iou_thr": 0.5,
                                                           "neg_iou_thr": 0.4, "min_pos_iou": 0,
                                                           "ignore_iof_thr": -1}},
                                "test_cfg": {"nms_pre": 1000, "min_bbox_size": 0,
                                             "score_thr": 0.05,
                                             "nms": {"type": "nms", "iou_threshold": 0.5},
                                             "max_per_img": 100}},
                            "inputs": [{"shape": [3, *FCOS_R50_SIZE], "dtype": "float16"}]}},
        "joint_loss": {"normalize_weights": False,
                       "losses": [{**loss, "weight": 1.0} for loss in FCOS_LOSSES]},
        "optimization": [{"optimizer": {"name": "SGD",
                                        "params": {"lr": 0.001, "momentum": 0.9,
                                                   "weight_decay": 0.0001}},
                          "scheduler": {"name": "MultiStepLR", "params": {"milestones": [16]}}}],
        "data": {"TRAIN": _r50_data(os.path.join(data_root, "train"), True),
                 "VALID": _r50_data(os.path.join(data_root, "valid"), False)},
        "trainer": {"accelerator": "auto", "max_epochs": 1, "precision": 16,
                    "gradient_clip_val": 35, "gradient_clip_algorithm": "norm",
                    "num_sanity_val_steps": 0},
        "seed_params": {"seed": 0},
        "metrics": [{"name": "MMDetectionMAP", "tag": "MMDetMAP_50",
                     "params": {"iou_thr": 0.5, "num_classes": 80},
                     "mapping": {"preds": "prediction", "target": "target"},
                     "phases": ["VALID"]}],
    }


def write_box_images(root, n, seed, size=FCOS_R50_SIZE, classes=80):
    """``n`` synthetic PNGs of ``size`` with 1 to 12 filled boxes each, 12
    to 640 pixels a side (every FCOS level's range gets boxes), on a blocky
    background, and their ``ann.csv`` (COCO boxes, labels in [0, classes))."""
    import csv
    import json
    import numpy as np
    from torchok_tpu_torch.native import encode_png

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = size
    rows = []
    for i in range(n):
        img = np.repeat(np.repeat(rng.integers(0, 90, (h // 8, w // 8, 3), dtype=np.uint8),
                                  8, 0), 8, 1)
        boxes, labels = [], []
        for _ in range(int(rng.integers(1, 13))):
            bw, bh = (int(v) for v in np.exp(rng.uniform(np.log(12), np.log(640), 2)))
            bw, bh = min(bw, w - 2), min(bh, h - 2)
            x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            cls = int(rng.integers(0, classes))
            img[y0:y0 + bh, x0:x0 + bw] = (40 + 2 * cls, 200 - 2 * cls, 120 + cls)
            boxes.append([x0, y0, bw, bh])
            labels.append(cls)
        name = f"{i}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(encode_png(img))
        rows.append({"image_path": name, "bbox": json.dumps(boxes), "label": json.dumps(labels)})
    with open(os.path.join(root, "ann.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["image_path", "bbox", "label"])
        writer.writeheader()
        writer.writerows(rows)


def _detr_loss(name, tag, weight, mapping, **params):
    loss = {"name": name, "tag": tag, "weight": weight, "mapping": mapping}
    return {**loss, "params": params} if params else loss


# the three losses and their mappings of the DETR recipes
DETR_LOSSES = [
    _detr_loss("MMCrossEntropyLoss", "loss_cls", 1.0,
               {"cls_score": "cls_scores", "label": "labels", "weight": "label_weights",
                "avg_factor": "cls_avg_factor"}, use_sigmoid=False, class_weight=1.0),
    _detr_loss("MMGIoULoss", "loss_iou", 2.0,
               {"pred": "bboxes", "target": "bboxes_gt", "weight": "bbox_weights",
                "avg_factor": "num_total_pos"}),
    _detr_loss("MML1Loss", "loss_bbox", 5.0,
               {"pred": "bbox_preds", "target": "bbox_targets", "weight": "bbox_weights",
                "avg_factor": "num_total_pos"}),
]

# configs/detection_toy_detr.yaml, the DETR north star on the toy set (a CPU
# test holds the two equal)
DETR_RECIPE = {
    "task": {"name": "SingleStageDetectionTask",
             "params": {"backbone_name": "resnet18",
                        "backbone_params": {"pretrained": False, "in_channels": 3},
                        "num_scales": 1, "head_name": "DETRHead",
                        "head_params": {"num_classes": 2, "num_queries": 64, "embed_dim": 128,
                                        "num_heads": 8, "num_encoder_layers": 3,
                                        "num_decoder_layers": 3, "ffn_dim": 512,
                                        "dropout": 0.0,
                                        "test_cfg": {"score_thr": 0.0, "max_per_img": 10}},
                        "inputs": [{"shape": [3, 96, 96], "dtype": "float32"}]}},
    "joint_loss": {"normalize_weights": False, "losses": copy.deepcopy(DETR_LOSSES)},
    "optimization": [{"optimizer": {"name": "AdamW",
                                    "params": {"lr": 0.0001, "weight_decay": 0.0001}},
                      "scheduler": {"name": "CosineAnnealingLR", "params": {"T_max": 300}}}],
    "data": {"TRAIN": _toydet_data("train", True), "VALID": _toydet_data("valid", False)},
    "trainer": {"max_epochs": 300, "precision": 32, "num_sanity_val_steps": 0,
                "check_val_every_n_epoch": 10, "steps_per_execution": 4,
                "gradient_clip_val": 0.1, "gradient_clip_algorithm": "norm"},
    "seed_params": {"seed": 7},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/toydet/logs",
               "experiment_name": "detr_resnet18",
               "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}", "name": "CSVLogger"},
    "callbacks": [{"name": "FinalizeLogger"},
                  {"name": "ModelCheckpoint",
                   "params": {"dirpath": "${oc.env:HOME}/.cache/torchok_tpu/toydet/ckpt",
                              "monitor": "valid/map50", "save_top_k": 1, "mode": "max"}}],
    "metrics": copy.deepcopy(FCOS_RECIPE["metrics"]),
}
# the short budget of tools/north_star_baselines.json ("detr"), held one-sided
# to valid/map50 >= 0.2605 - 0.05 as tools/check_north_stars.py does
DETR_OVERRIDES = ["trainer.max_epochs=100", "optimization.0.scheduler.params.T_max=100"]
DETR_REFERENCE = 0.2605
DETR_TOLERANCE = 0.05
# steps_per_execution 4 over super-batches of 128 with drop_last: 2000 // 128
# = 15 executions, 60 steps an epoch; a validation every 10 epochs
DETR_STEPS = 100 * (2000 // 128) * 4
DETR_VALIDATIONS = 10
# the smoke's DETR phase: the port's draws it trains side by side, each in a
# process of its own, the gate held to the mean of their map50 (the
# reference's decoding); the overrides it adds to the short budget's: a
# reproducible run, and two loader workers a loader, so that five runs of a
# main process and four workers a loader do not crowd the host's 8 cores
# (each sample draws from (seed, epoch, index), so the batches are the same)
DETR_DRAWS = (0, 1, 2, 3, 7)
DETR_PHASE_OVERRIDES = ["+trainer.deterministic=true", "data.TRAIN.0.dataloader.num_workers=2",
                        "data.VALID.0.dataloader.num_workers=2"]


def detr_config(data_root: str, log_dir: str) -> dict:
    """The DETR recipe with the short budget's overrides, reading the toy set
    under ``data_root``, logging and checkpointing under ``log_dir``."""
    overrides = DETR_OVERRIDES + [f"data.{phase}.0.dataset.params.data_folder="
                                  f"{os.path.join(data_root, split)}"
                                  for phase, split in (("TRAIN", "train"), ("VALID", "valid"))]
    cfg = _with_overrides(DETR_RECIPE, overrides, log_dir)
    cfg["callbacks"][1]["params"]["dirpath"] = os.path.join(log_dir, "ckpt")
    return cfg


_SWEET_PEPPER_JITTER = {"name": "ColorJitter", "params": {"brightness": 0.4, "contrast": 0.4,
                                                          "saturation": 0.4, "hue": 0.1}}
_SWEET_PEPPER_ONEOF = {"name": "OneOf", "params": {"p": 1.0, "transforms": [
    {"name": "ElasticTransform", "params": {"border_mode": 1}}, {"name": "GridDistortion"},
    {"name": "GaussNoise"}, _SWEET_PEPPER_JITTER]}}
_SWEET_PEPPER_TRANSFORM = [
    {"name": "Resize", "params": {"height": 256, "width": 256, "interpolation": 0}},
    {"name": "Normalize", "params": {"mean": [0.485, 0.456, 0.406],
                                     "std": [0.229, 0.224, 0.225]}},
    {"name": "ToTensorV2"}]
_SWEET_PEPPER_AUGMENT = [
    {"name": "HorizontalFlip"}, {"name": "VerticalFlip"},
    {"name": "Compose", "params": {"p": 0.5, "transforms": [
        {"name": "PadIfNeeded", "params": {"min_height": 256, "min_width": 256}},
        {"name": "CenterCrop", "params": {"height": 256, "width": 256}}]}},
    _SWEET_PEPPER_ONEOF, copy.deepcopy(_SWEET_PEPPER_ONEOF)]


def _sweet_pepper_data(train):
    dataset = {"name": "SweetPepper",
               "params": {"train": train, "download": True,
                          "data_folder": "${oc.env:HOME}/.cache/torchok_tpu/sweet_pepper/data"},
               "transform": copy.deepcopy(_SWEET_PEPPER_TRANSFORM)}
    if train:
        dataset["augment"] = copy.deepcopy(_SWEET_PEPPER_AUGMENT)
    return [{"dataloader": {"batch_size": 8, "num_workers": 4, "drop_last": train,
                            "shuffle": train}, "dataset": dataset}]


_SWEET_PEPPER_LOGS = "${logger.log_dir}/${logger.experiment_name}/${logger.timestamp}"
# configs/segmentation_sweet_pepper.yaml (a CPU test holds the two equal)
SWEET_PEPPER_RECIPE = {
    "task": {"name": "SegmentationTask",
             "params": {"backbone_name": "hrnet_w18",
                        "backbone_params": {"pretrained": True, "in_channels": 3},
                        "neck_name": "HRNetSegmentationNeck", "head_name": "SegmentationHead",
                        "head_params": {"num_classes": 3},
                        "inputs": [{"shape": [3, 256, 256], "dtype": "float32"}]}},
    "joint_loss": {"losses": [
        {"name": "CrossEntropyLoss", "mapping": {"input": "prediction", "target": "target"}},
        {"name": "DiceLoss", "params": {"mode": "multiclass"},
         "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}},
                      "scheduler": {"name": "ExponentialLR", "params": {"gamma": 0.97}}}],
    "data": {"TRAIN": _sweet_pepper_data(True), "VALID": _sweet_pepper_data(False)},
    "trainer": {"accelerator": "auto", "max_epochs": 30, "log_every_n_steps": 1000},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/sweet_pepper/logs",
               "experiment_name": "hrnet_w18", "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}",
               "name": "TensorBoardLogger"},
    "hydra": {"run": {"dir": _SWEET_PEPPER_LOGS}},
    "callbacks": [{"name": "ModelCheckpointWithOnnx",
                   "params": {"dirpath": _SWEET_PEPPER_LOGS, "monitor": "valid/JaccardIndex",
                              "save_top_k": 1, "save_last": True, "mode": "max",
                              "save_weights_only": False, "export_to_onnx": True,
                              "onnx_params": {"opset_version": 16}}},
                  {"name": "FinalizeLogger"},
                  {"name": "TQDMProgressBar", "params": {"refresh_rate": 5}}],
    "metrics": [{"name": "JaccardIndex", "params": {"num_classes": 3, "ignore_index": 0},
                 "mapping": {"preds": "prediction", "target": "target"}}],
}
# the smoke's cut: one epoch of 40 steps at bs 8, one validation of 64 images
SWEET_PEPPER_TRAIN, SWEET_PEPPER_VALID = 320, 64
SWEET_PEPPER_STEPS = SWEET_PEPPER_TRAIN // 8


def _data_folders(cfg, folder):
    """Point every dataset of ``cfg`` at ``folder``."""
    for loaders in cfg["data"].values():
        for loader in loaders:
            loader["dataset"]["params"]["data_folder"] = folder


def sweet_pepper_config(log_dir: str, data_folder: str):
    """The sweet-pepper recipe as the smoke runs it, and the list of its
    cuts: its data pipeline, model and callbacks verbatim (ModelCheckpointWithOnnx
    included), but random weights, the files :func:`write_sweet_pepper_tree`
    wrote under ``data_folder``, one epoch and CSVLogger under ``log_dir``
    (the card machine has no tensorboardX)."""
    cfg = copy.deepcopy(SWEET_PEPPER_RECIPE)
    cfg["task"]["params"]["backbone_params"]["pretrained"] = False
    _data_folders(cfg, data_folder)
    cfg["trainer"]["max_epochs"] = 1
    cfg["logger"].update(name="CSVLogger", log_dir=log_dir)
    del cfg["hydra"]
    cuts = ["task.params.backbone_params.pretrained=false (random weights from the seed)",
            f"data_folder -> {data_folder} ({SWEET_PEPPER_TRAIN} train and {SWEET_PEPPER_VALID} "
            "valid 256x256 PNG images with gray PNG masks, written by the script; nothing "
            "downloaded)",
            "trainer.max_epochs=1", "logger TensorBoardLogger -> CSVLogger"]
    return cfg, cuts


def sweet_pepper_arrays(n: int, train: bool, size: int = 256):
    """Images and 3-class masks of the written sweet-pepper set: the shapes
    segmentation set's (seeded numpy) with its ten pattern labels folded into
    the recipe's two object classes (odd patterns 1, even 2; background 0)."""
    import numpy as np
    from torchok_tpu_torch.data.datasets.examples.synthetic import (
        SyntheticShapesSegmentationDataset)
    data = SyntheticShapesSegmentationDataset(None, num_samples=n, image_size=(size, size),
                                              train=train)
    return data.images, np.where(data.masks > 0, 2 - data.masks % 2, 0).astype(np.uint8)


def write_sweet_pepper_tree(root, train: int = SWEET_PEPPER_TRAIN, valid: int = SWEET_PEPPER_VALID,
                            size: int = 256):
    """``<root>/sweet_pepper/{train,valid}.csv`` (columns ``image``, ``mask``)
    and the files they name: RGB PNG images and gray PNG masks of
    :func:`sweet_pepper_arrays`, written without cv2 or pandas (stored, zlib
    level 0: quick to write and to read)."""
    import csv
    from torchok_tpu_torch import native
    base = os.path.join(root, "sweet_pepper")
    for split, n, train_split in (("train", train, True), ("valid", valid, False)):
        os.makedirs(os.path.join(base, split, "images"), exist_ok=True)
        os.makedirs(os.path.join(base, split, "masks"), exist_ok=True)
        images, masks = sweet_pepper_arrays(n, train_split, size)
        rows = []
        for i, (image, mask) in enumerate(zip(images, masks)):
            row = {"image": f"{split}/images/{i:04d}.png", "mask": f"{split}/masks/{i:04d}.png"}
            for key, pixels in (("image", image), ("mask", mask)):
                with open(os.path.join(base, row[key]), "wb") as f:
                    f.write(native.encode_png(pixels, level=0))
            rows.append(row)
        with open(os.path.join(base, f"{split}.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, ["image", "mask"])
            writer.writeheader()
            writer.writerows(rows)
    return base


# ---------------------------------------------------------------- SOP recipes
_SOP_FOLDER = "${oc.env:HOME}/.cache/torchok_tpu/sop/data"
_SOP_LOGS = "${logger.log_dir}/${logger.experiment_name}/${logger.timestamp}"
_SOP_METER = {"name": "HitAtKMeter",
              "params": {"k": 1, "dataset_type": "classification", "normalize_vectors": True,
                         "search_batch_size": 256}}
_SOP_CALLBACKS_TAIL = [{"name": "FinalizeLogger"},
                       {"name": "TQDMProgressBar", "params": {"refresh_rate": 5}}]
_SOP_CHECKPOINT = {"dirpath": _SOP_LOGS, "monitor": "valid/HitAtKMeter", "save_top_k": 2,
                   "save_last": True, "mode": "min", "save_weights_only": False}


def _sop_transform(size):
    return [{"name": "Resize", "params": {"height": size, "width": size}},
            {"name": "Normalize", "params": {"mean": [0.485, 0.456, 0.406],
                                             "std": [0.229, 0.224, 0.225]}},
            {"name": "ToTensorV2"}]


def _sop_augment(size, oneofs):
    return [{"name": "HorizontalFlip"}, {"name": "VerticalFlip"},
            {"name": "Compose", "params": {"p": 0.5, "transforms": [
                {"name": "PadIfNeeded", "params": {"min_height": size, "min_width": size}},
                {"name": "CenterCrop", "params": {"height": size, "width": size}}]}}] + \
        [copy.deepcopy(_SWEET_PEPPER_ONEOF) for _ in range(oneofs)]


def _sop_loader(batch, workers, train, name, params, size, oneofs=0):
    dataset = {"name": name, "params": {**params, "download": True, "data_folder": _SOP_FOLDER},
               "transform": _sop_transform(size)}
    if oneofs:
        dataset["augment"] = _sop_augment(size, oneofs)
    return [{"dataloader": {"batch_size": batch, "num_workers": workers, "drop_last": train,
                            "shuffle": train}, "dataset": dataset}]


def _sop_task(name, backbone, size, **params):
    return {"name": name, "params": {
        "backbone_name": backbone, "backbone_params": {"pretrained": True, "in_channels": 3},
        **params, "inputs": [{"shape": [3, size, size], "dtype": "float32"}]}}


def _sop_logger(log_dir, experiment):
    return {"log_dir": log_dir, "experiment_name": experiment,
            "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}", "name": "TensorBoardLogger"}


_LINEAR_HEAD = {"pooling_name": "Pooling", "head_name": "LinearHead",
                "head_params": {"out_channels": 512, "normalize": True}}
# configs/pairwise_sop.yaml, configs/triplet_sop.yaml and
# configs/representation_arcface_sop.yaml (a CPU test holds each equal)
PAIRWISE_SOP_RECIPE = {
    "task": _sop_task("PairwiseLearnTask", "resnet18", 224, **_LINEAR_HEAD, num_classes=11318),
    "joint_loss": {"losses": [{"name": "ContrastiveLoss", "params": {"margin": 1.0},
                               "mapping": {"emb1": "emb1", "emb2": "emb2", "R": "R"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}},
                      "scheduler": {"name": "OneCycleLR", "params": {
                          "epochs": 20, "steps_per_epoch": 100, "max_lr": 0.0001,
                          "pct_start": 0.1}}}],
    "data": {"TRAIN": _sop_loader(64, 4, True, "SOP", {"train": True, "input_dtype": "float32"},
                                  224, oneofs=1),
             "VALID": _sop_loader(64, 4, False, "SOP", {"train": False}, 224)},
    "trainer": {"accelerator": "auto", "max_epochs": 30, "log_every_n_steps": 10},
    "logger": _sop_logger("${oc.env:HOME}/.cache/torchok_tpu/sop/logs", "pairwise_resnet18"),
    "hydra": {"run": {"dir": _SOP_LOGS}},
    "callbacks": [{"name": "ModelCheckpoint", "params": dict(_SOP_CHECKPOINT)},
                  *copy.deepcopy(_SOP_CALLBACKS_TAIL)],
    "metrics": [{**copy.deepcopy(_SOP_METER),
                 "mapping": {"vectors": "emb1", "group_labels": "target"}, "phases": ["VALID"]}],
}
TRIPLET_SOP_RECIPE = {
    "task": {**_sop_task("TripletLearnTask", "resnet18", 224, **_LINEAR_HEAD),
             "compute_loss_on_valid": False},
    "joint_loss": {"losses": [{"name": "TripletMarginLoss", "mapping": {
        "anchor": "anchor", "positive": "positive", "negative": "negative"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}},
                      "scheduler": {"name": "ExponentialLR", "params": {"gamma": 0.97}}}],
    "data": {"TRAIN": _sop_loader(4, 4, True, "TRIPLET_SOP",
                                  {"train": True, "input_dtype": "float32"}, 224),
             "VALID": _sop_loader(64, 4, False, "SOP",
                                  {"train": False, "input_dtype": "float32"}, 224)},
    "trainer": {"accelerator": "auto", "max_epochs": 2, "log_every_n_steps": 10},
    "logger": _sop_logger("${oc.env:HOME}/.cache/torchok_tpu/sop/logs", "triplet_resnet18"),
    "hydra": {"run": {"dir": _SOP_LOGS}},
    "callbacks": [{"name": "ModelCheckpoint", "params": dict(_SOP_CHECKPOINT)},
                  *copy.deepcopy(_SOP_CALLBACKS_TAIL)],
    "metrics": [{**copy.deepcopy(_SOP_METER),
                 "mapping": {"vectors": "embeddings", "group_labels": "target"},
                 "phases": ["VALID"]}],
}
ARCFACE_SOP_RECIPE = {
    "task": {**_sop_task("ClassificationTask", "semnasnet_100", 256,
                         pooling_name="PoolingLinear", pooling_params={"out_channels": 512},
                         head_name="ArcFaceHead", head_params={"num_classes": 11318}),
             "compute_loss_on_valid": False},
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "SGD", "params": {
        "lr": 0.001, "momentum": 0.9, "nesterov": True, "weight_decay": 0.00005}}}],
    "data": {"TRAIN": _sop_loader(64, 4, True, "SOP", {"input_dtype": "float32", "train": True},
                                  256, oneofs=2),
             "VALID": _sop_loader(64, 16, False, "SOP",
                                  {"input_dtype": "float32", "train": False}, 256)},
    "trainer": {"accelerator": "auto", "max_epochs": 30, "precision": 32,
                "num_sanity_val_steps": 0},
    "logger": _sop_logger("${oc.env:HOME}/.cache/torchok_tpu/sop/logs/", "semnasnet_100"),
    "hydra": {"run": {"dir": _SOP_LOGS}},
    "callbacks": [
        {"name": "FreezeUnfreeze", "params": {"freeze_modules": [
            {"module_name": "backbone", "epoch": 2},
            {"module_name": "backbone", "stage": 1},
            {"module_name": "backbone", "module_class": "_BatchNorm", "bn_requires_grad": False,
             "bn_track_running_stats": False},
            {"module_name": "", "module_class": "Dropout"}]}},
        {"name": "ModelCheckpointWithOnnx",
         "params": {**_SOP_CHECKPOINT, "export_to_onnx": True, "remove_head": True}},
        *copy.deepcopy(_SOP_CALLBACKS_TAIL)],
    "metrics": [{"name": "Accuracy", "mapping": {"preds": "prediction", "target": "target"},
                 "phases": ["TRAIN"]},
                {**copy.deepcopy(_SOP_METER),
                 "mapping": {"vectors": "embeddings", "group_labels": "target"},
                 "phases": ["VALID"]}],
}
SOP_RECIPES = {"pairwise_sop": PAIRWISE_SOP_RECIPE, "triplet_sop": TRIPLET_SOP_RECIPE,
               "representation_arcface_sop": ARCFACE_SOP_RECIPE}
# the smoke's cut: one epoch of these many steps of each
SOP_LIMIT_TRAIN = {"pairwise_sop": 3, "triplet_sop": 8, "representation_arcface_sop": 3}
# the written SOP tree: classes (train, test), images a class, triplets
SOP_CLASSES = (40, 32)
SOP_PER_CLASS = 8
SOP_TRIPLETS = 100
SOP_HEADER = ["image_id", "class_id", "super_class_id", "path"]
# the tolerance of an artifact's replay: of the live eval forward's largest magnitude
REPLAY_TOLERANCE = 1e-5
# an artifact replays every VALID image at batch 64 and the first these many
# one at a time (a batch of 1 runs as two copies: one graph, one image apart)
REPLAY_SINGLES = 8


def sop_config(recipe: str, data_folder: str, log_dir: str):
    """SOP recipe ``recipe`` as the smoke runs it, and the list of its cuts:
    its data pipeline, model, optimizer and callbacks verbatim, but random
    weights, the files :func:`write_sop_tree` wrote under ``data_folder``,
    one epoch of ``SOP_LIMIT_TRAIN[recipe]`` steps, CSVLogger under
    ``log_dir``."""
    cfg = copy.deepcopy(SOP_RECIPES[recipe])
    cfg["task"]["params"]["backbone_params"]["pretrained"] = False
    _data_folders(cfg, data_folder)
    cfg["trainer"].update(max_epochs=1, limit_train_batches=SOP_LIMIT_TRAIN[recipe])
    cfg["logger"].update(name="CSVLogger", log_dir=log_dir)
    del cfg["hydra"]
    cuts = ["task.params.backbone_params.pretrained=false (random weights from the seed)",
            f"data_folder -> {data_folder} (a SOP tree written by the script, nothing "
            "downloaded)", "trainer.max_epochs=1",
            f"trainer.limit_train_batches={SOP_LIMIT_TRAIN[recipe]}",
            "logger TensorBoardLogger -> CSVLogger"]
    return cfg, cuts


def sop_image(label: int, rng, sizes=(200, 400)):
    """The pixels of one image of class ``label``: stripes whose two colours,
    angle and period the class fixes, at a random size of ``sizes`` a side,
    with a random phase and additive noise."""
    import numpy as np
    h, w = (int(v) for v in rng.integers(sizes[0], sizes[1] + 1, 2))
    klass = np.random.default_rng([7, label])
    colours = klass.integers(0, 256, (2, 3)).astype(np.int16)
    angle, period = klass.uniform(0, np.pi), klass.uniform(8, 40)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    wave = np.sin((xx * np.cos(angle) + yy * np.sin(angle)) * (2 * np.pi / period)
                  + rng.uniform(0, 2 * np.pi))
    image = np.where(wave[..., None] > 0, colours[0], colours[1])
    image = image + rng.integers(-12, 13, (h, w, 1), dtype=np.int16)
    return np.clip(image, 0, 255).astype(np.uint8)


def write_sop_tree(root, seed: int = 0, classes=SOP_CLASSES, per_class: int = SOP_PER_CLASS,
                   triplets: int = SOP_TRIPLETS, sizes=(200, 400)):
    """``<root>/Stanford_Online_Products`` as SOP lays it out, without cv2 or
    pandas: ``Ebay_train.txt`` (class ids from 1) and ``Ebay_test.txt``
    (from 11319), space-separated with SOP's header, the PNGs of
    :func:`sop_image` they name (``per_class`` a class, in class order;
    stored, zlib level 0), and
    ``Ebay_triplets.txt`` (``anchor positive negative``) of ``triplets``
    train triplets. Returns the number of PNGs written."""
    import numpy as np
    from torchok_tpu_torch import native
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "Stanford_Online_Products")
    image_id, by_class = 1, {}
    for split, n_classes, first in (("train", classes[0], 1), ("test", classes[1], 11319)):
        lines = [" ".join(SOP_HEADER)]
        for class_id in range(first, first + n_classes):
            os.makedirs(os.path.join(base, f"class_{class_id:05d}"), exist_ok=True)
            for _ in range(per_class):
                path = f"class_{class_id:05d}/{image_id:06d}.png"
                with open(os.path.join(base, path), "wb") as f:
                    f.write(native.encode_png(sop_image(class_id, rng, sizes), level=0))
                lines.append(f"{image_id} {class_id} {class_id % 12 + 1} {path}")
                by_class.setdefault(split, {}).setdefault(class_id, []).append(path)
                image_id += 1
        with open(os.path.join(base, f"Ebay_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    train = by_class["train"]
    ids = sorted(train)
    lines = ["anchor positive negative"]
    for _ in range(triplets):
        pos_class, neg_class = rng.choice(ids, 2, replace=False)
        anchor, positive = rng.choice(train[pos_class], 2, replace=False)
        lines.append(f"{anchor} {positive} {rng.choice(train[neg_class])}")
    with open(os.path.join(base, "Ebay_triplets.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return image_id - 1


# configs/stablehlo_infer.yaml (a CPU test holds the two equal)
_CIFAR_FOLDER = "${oc.env:HOME}/.cache/torchok_tpu/cifar10/data"
_INFER_TRANSFORM = [{"name": "Resize", "params": {"height": 32, "width": 32}},
                    {"name": "Normalize", "params": {"mean": [0.485, 0.456, 0.406],
                                                     "std": [0.229, 0.224, 0.225]}},
                    {"name": "ToTensorV2"}]
STABLEHLO_INFER_RECIPE = {
    "task": {"name": "ONNXTask", "params": {
        "path_to_onnx": "<onnx_path>", "providers": ["CUDAExecutionProvider"],
        "keys_mapping_onnx2dataset": {"input.1": "image"}}},
    "data": {
        "TEST": [{"dataloader": {"batch_size": 8, "num_workers": 4, "drop_last": False,
                                 "shuffle": False},
                  "dataset": {"name": "CIFAR10", "params": {
                      "train": False, "download": True, "data_folder": _CIFAR_FOLDER},
                      "transform": copy.deepcopy(_INFER_TRANSFORM)}}],
        "PREDICT": [{"dataloader": {"batch_size": 8, "num_workers": 1, "drop_last": False,
                                    "shuffle": False},
                     "dataset": {"name": "CIFAR10", "params": {
                         "train": False, "download": True, "test_mode": True,
                         "data_folder": _CIFAR_FOLDER},
                         "transform": copy.deepcopy(_INFER_TRANSFORM)}}]},
    "trainer": {"accelerator": "gpu", "max_epochs": 1},
    "logger": {"log_dir": "${oc.env:HOME}/.cache/torchok_tpu/cifar10/logs",
               "experiment_name": "cifar10", "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}",
               "name": "TensorBoardLogger"},
    "hydra": {"run": {"dir": "${logger.log_dir}/${logger.experiment_name}/${logger.timestamp}"}},
    "callbacks": [{"name": "FinalizeLogger"},
                  {"name": "TQDMProgressBar", "params": {"refresh_rate": 5}}],
    "metrics": [{"name": "Accuracy", "mapping": {"preds": "<onnx_output>", "target": "target"}},
                {"name": "F1Score", "mapping": {"preds": "<onnx_output>", "target": "target"}}],
}


def stablehlo_infer_config(artifact: str, data_folder: str, log_dir: str):
    """``configs/stablehlo_infer.yaml`` as the smoke runs it, and its cuts:
    the placeholders filled (``<onnx_path>`` the artifact, ``<onnx_output>``
    ``prediction``), the CIFAR-10 folder the script wrote, CSVLogger."""
    cfg = copy.deepcopy(STABLEHLO_INFER_RECIPE)
    cfg["task"]["params"]["path_to_onnx"] = artifact
    for metric in cfg["metrics"]:
        metric["mapping"]["preds"] = "prediction"
    _data_folders(cfg, data_folder)
    cfg["logger"].update(name="CSVLogger", log_dir=log_dir)
    del cfg["hydra"]
    cuts = [f"<onnx_path> -> {artifact}", "<onnx_output> -> prediction",
            f"data_folder -> {data_folder} (the shapes VALID set as a CIFAR-10 test batch)",
            "CIFAR10's md5 of each batch file -> none (the written files are not CIFAR-10's)",
            "logger TensorBoardLogger -> CSVLogger"]
    return cfg, cuts


# configs/classification_swinv2_tiny_spatial_aug_train.yaml: swinv2_tiny at
# full width trained through a device geometry suffix on uint8 288x288 images
SPATIAL_SIZE = 288
SPATIAL_BATCH = 64
SPATIAL_STEPS = 12
SPATIAL_SUFFIX = ["RandomResizedCrop", "HorizontalFlip", "ShiftScaleRotate", "Perspective",
                  "RandomRotate90", "Normalize", "ToTensorV2"]
SPATIAL_TRAIN_CONFIG = {
    "task": _task("swinv2_tiny_window8_256", 256),
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}}}],
    "data": {
        "TRAIN": [{
            "dataloader": {"batch_size": SPATIAL_BATCH, "num_workers": 2, "drop_last": True,
                           "shuffle": True},
            "dataset": {
                "name": "SyntheticClassificationDataset",
                "params": {"num_samples": 1024, "num_classes": 1000,
                           "image_size": [SPATIAL_SIZE, SPATIAL_SIZE]},
                "augment": [{"name": "RandomResizedCrop", "params": {"height": 256, "width": 256}},
                            {"name": "HorizontalFlip"}, {"name": "ShiftScaleRotate"},
                            {"name": "Perspective"}, {"name": "RandomRotate90"}],
                "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}],
        "VALID": _synthetic(SPATIAL_BATCH, False, False, 256, SPATIAL_BATCH, seed=1)},
    "trainer": {"accelerator": "gpu", "precision": 16, "max_epochs": 1,
                "limit_train_batches": SPATIAL_STEPS, "log_every_n_steps": 1},
    "seed_params": {"seed": 42},
    "metrics": [{"name": "Accuracy", **_METRIC}],
}
# swinv2_tiny's pyramid norms of stages 1 to 3 feed no classification head:
# they get no gradient and must stay as they were
SPATIAL_UNUSED = ("backbone.feature_norms.0.", "backbone.feature_norms.1.",
                  "backbone.feature_norms.2.")
# every device path of the slice, card against CPU under the same draws:
# (name, params, exact); exact for crops, permutations and nearest sampling,
# a bound for the bilinear ones (SPATIAL_LEVEL_SHARE, SPATIAL_FLOAT_TOL)
SPATIAL_DEVICE_CASES = (
    ("Rotate", {"limit": 30, "p": 0.7}, False),
    ("Rotate", {"limit": 45, "border_mode": 0, "value": 7, "mask_value": 3, "interpolation": 0,
                "p": 0.7}, True),
    ("SafeRotate", {"limit": 60, "border_mode": 1, "p": 0.7}, False),
    ("ShiftScaleRotate", {"p": 0.7}, False),
    ("Affine", {"scale": 0.2, "translate_percent": 0.1, "rotate": 20, "shear": 10, "p": 0.7},
     False),
    ("Affine", {"rotate": 30, "interpolation": 0, "p": 0.7}, True),
    ("Perspective", {"scale": (0.05, 0.15), "p": 0.7}, False),
    ("Perspective", {"scale": 0.1, "interpolation": 0, "p": 0.7}, True),
    ("OpticalDistortion", {"distort_limit": 0.5, "shift_limit": 0.1, "p": 0.7}, False),
    ("OpticalDistortion", {"distort_limit": 0.8, "border_mode": 0, "interpolation": 0,
                           "p": 0.7}, True),
    ("RandomResizedCrop", {"height": 224, "width": 224}, False),
    ("RandomSizedCrop", {"min_max_height": (128, 256), "height": 224, "width": 224}, False),
    ("RandomRotate90", {"p": 0.7}, True),
    ("Transpose", {"p": 0.5}, True),
    ("RandomGridShuffle", {"grid": (3, 3), "p": 0.7}, True),
    ("CropAndPad", {"px": [-20, 30, 40, -10], "p": 0.7}, False),
    ("CropAndPad", {"percent": 0.1, "pad_mode": 4, "interpolation": 0, "p": 0.7}, True),
    ("FitResize", {"max_height": 200, "max_width": 180}, False),
    ("FitResize", {"max_height": 300, "max_width": 400, "interpolation": 0}, True),
    ("PadIfNeeded", {"min_height": 300, "min_width": 280}, True),
    ("PadIfNeeded", {"min_height": 320, "min_width": 300, "border_mode": 0, "value": 7,
                     "mask_value": 3}, True),
    ("LongestMaxSize", {"max_size": 200}, False),
    ("SmallestMaxSize", {"max_size": 300, "interpolation": 0}, True),
    ("Crop", {"x_min": 10, "y_min": 20, "x_max": 200, "y_max": 230}, True),
)
SPATIAL_LEVEL_SHARE = 0.01
SPATIAL_FLOAT_TOL = 1e-4
# each new host transform, forced, timed in a loader worker process
SPATIAL_HOST_CASES = (
    ("Rotate", {}), ("SafeRotate", {}), ("ShiftScaleRotate", {}),
    ("Affine", {"scale": 0.1, "rotate": 20, "shear": 5}), ("Perspective", {}),
    ("OpticalDistortion", {}), ("Crop", {"x_max": 200, "y_max": 200}),
    ("RandomResizedCrop", {"height": 256, "width": 256}),
    ("RandomSizedCrop", {"min_max_height": (128, 256), "height": 256, "width": 256}),
    ("LongestMaxSize", {"max_size": 256}), ("SmallestMaxSize", {"max_size": 256}),
    ("FitResize", {"max_height": 256, "max_width": 256}),
    ("PadIfNeeded", {"min_height": 400, "min_width": 400}), ("CropAndPad", {"px": (-20, 20)}),
    ("RandomRotate90", {}), ("Transpose", {}), ("RandomGridShuffle", {}), ("RandomScale", {}),
    ("BBoxSafeRandomCrop", {"erosion_rate": 0.2}),
    ("RandomSizedBBoxSafeCrop", {"height": 256, "width": 256}), ("RandomCropFromBorders", {}),
    ("RandomCropNearBBox", {}), ("CropNonEmptyMaskIfExists", {"height": 256, "width": 256}),
    ("PiecewiseAffine", {}), ("MaskDropout", {"max_objects": 2}), ("Lambda", {}),
)

# configs/classification_gcvit_tiny_photometric_aug_train.yaml: gcvit_tiny at
# full width trained through a device photometric suffix on uint8 224x224
# images
PHOTOMETRIC_SIZE = 224
PHOTOMETRIC_BATCH = 64
PHOTOMETRIC_STEPS = 12
PHOTOMETRIC_SUFFIX = ["RandomBrightnessContrast", "HueSaturationValue", "CLAHE", "RandomGamma",
                      "GaussianBlur", "MotionBlur", "Sharpen", "CoarseDropout", "ToGray",
                      "Normalize", "ToTensorV2"]
PHOTOMETRIC_TRAIN_CONFIG = {
    "task": _task("gcvit_tiny", PHOTOMETRIC_SIZE, img_size=PHOTOMETRIC_SIZE),
    "joint_loss": {"losses": [{"name": "CrossEntropyLoss",
                               "mapping": {"input": "prediction", "target": "target"}}]},
    "optimization": [{"optimizer": {"name": "Adam", "params": {"lr": 0.0001}}}],
    "data": {
        "TRAIN": [{
            "dataloader": {"batch_size": PHOTOMETRIC_BATCH, "num_workers": 2, "drop_last": True,
                           "shuffle": True},
            "dataset": {
                "name": "SyntheticClassificationDataset",
                "params": {"num_samples": 1024, "num_classes": 1000,
                           "image_size": [PHOTOMETRIC_SIZE, PHOTOMETRIC_SIZE]},
                "augment": [{"name": name} for name in PHOTOMETRIC_SUFFIX[:8]]
                + [{"name": "ToGray", "params": {"p": 0.2}}],
                "transform": [{"name": "Normalize"}, {"name": "ToTensorV2"}]}}],
        "VALID": _synthetic(PHOTOMETRIC_BATCH, False, False, PHOTOMETRIC_SIZE, PHOTOMETRIC_BATCH,
                            seed=1)},
    "trainer": {"accelerator": "gpu", "precision": 16, "max_epochs": 1,
                "limit_train_batches": PHOTOMETRIC_STEPS, "log_every_n_steps": 1},
    "seed_params": {"seed": 42},
    "metrics": [{"name": "Accuracy", **_METRIC}],
}
# every device path of the 27 names, card against CPU under the same draws:
# (name, params, exact, dtypes); exact where the path takes only
# operations that both devices round alike (CLAHE's cube root included), a
# bound where it takes a power or an exponential (PHOTOMETRIC_LEVEL_SHARE
# and PHOTOMETRIC_FLOAT_TOL); uint8-only names run on uint8 alone
PHOTOMETRIC_DEVICE_CASES = (
    ("Flip", {"p": 0.7}, True, ("uint8", "float32")),
    ("RandomBrightnessContrast", {"p": 0.7}, True, ("uint8", "float32")),
    ("RandomBrightness", {"limit": 0.4, "p": 0.7}, True, ("uint8", "float32")),
    ("RandomContrast", {"limit": 0.4, "p": 0.7}, True, ("uint8", "float32")),
    ("CoarseDropout", {"max_holes": 6, "max_height": 40, "min_height": 10, "max_width": 30,
                       "fill_value": 7, "mask_fill_value": 3, "p": 0.7}, True,
     ("uint8", "float32")),
    ("Cutout", {"num_holes": 4, "max_h_size": 30, "max_w_size": 20, "p": 0.7}, True,
     ("uint8", "float32")),
    ("InvertImg", {"p": 0.7}, True, ("uint8", "float32")),
    ("ToGray", {"p": 0.7}, True, ("uint8", "float32")),
    ("RandomGamma", {"gamma_limit": (50, 200), "p": 0.7}, False, ("uint8", "float32")),
    ("Solarize", {"threshold": 100, "p": 0.7}, True, ("uint8", "float32")),
    ("Posterize", {"num_bits": 3, "p": 0.7}, True, ("uint8",)),
    ("ChannelShuffle", {"p": 0.7}, True, ("uint8", "float32")),
    ("RGBShift", {"p": 0.7}, True, ("uint8", "float32")),
    ("ToFloat", {}, True, ("uint8", "float32")),
    ("FromFloat", {}, True, ("float32",)),
    ("FromFloat", {"dtype": "uint8", "max_value": 255}, True, ("float32",)),
    ("Blur", {"p": 0.7}, True, ("uint8", "float32")),
    ("GaussianBlur", {"p": 0.7}, True, ("uint8", "float32")),
    ("GaussianBlur", {"blur_limit": (3, 9), "sigma_limit": (0.3, 2.5), "p": 0.7}, False,
     ("uint8", "float32")),
    ("MedianBlur", {"p": 0.7}, True, ("uint8", "float32")),
    ("MotionBlur", {"p": 0.7}, True, ("uint8", "float32")),
    ("CLAHE", {"p": 0.7}, True, ("uint8",)),
    ("CLAHE", {"clip_limit": (1, 8), "tile_grid_size": (5, 3), "p": 0.7}, True, ("uint8",)),
    ("Equalize", {"p": 0.7}, True, ("uint8",)),
    ("HueSaturationValue", {"p": 0.7}, True, ("uint8",)),
    ("Downscale", {"scale_min": 0.2, "scale_max": 0.7, "p": 0.7}, True, ("uint8", "float32")),
    ("Sharpen", {"p": 0.7}, True, ("uint8", "float32")),
    ("ToSepia", {"p": 0.7}, True, ("uint8", "float32")),
)
PHOTOMETRIC_LEVEL_SHARE = 0.01
PHOTOMETRIC_FLOAT_TOL = 1e-4
# each new host transform, forced, timed in a loader worker process
PHOTOMETRIC_HOST_CASES = (
    ("Flip", {}), ("RandomBrightnessContrast", {}), ("RandomBrightness", {}),
    ("RandomContrast", {}), ("CoarseDropout", {}), ("Cutout", {}), ("InvertImg", {}),
    ("ToGray", {}), ("RandomGamma", {}), ("Solarize", {}), ("Posterize", {}),
    ("ChannelShuffle", {}), ("RGBShift", {}), ("ToFloat", {}), ("FromFloat", {}),
    ("Blur", {}), ("GaussianBlur", {}), ("MedianBlur", {}), ("MotionBlur", {}), ("CLAHE", {}),
    ("Equalize", {}), ("HueSaturationValue", {}), ("ImageCompression", {}),
    ("JpegCompression", {"quality_lower": 50, "quality_upper": 90}),
    ("Downscale", {"scale_min": 0.25, "scale_max": 0.5}), ("Sharpen", {}), ("ToSepia", {}),
)


def modules_loaded(names=("cv2", "jax", "torchok_tpu")):
    """Which of ``names`` this process has imported (run in a loader worker
    too)."""
    return sorted(n for n in names if n in sys.modules)


# configs/detection/detr_gcvit-t_coco.yaml's model at full width through its
# own COCODetection -> HorizontalFlip -> FitResize -> Normalize -> PadIfNeeded
# -> ToTensorV2 pipeline, from a synthetic COCO tree (write_coco_tree)
DETR_GCVIT_SIZE = (400, 672)
DETR_GCVIT_BATCH = 8
DETR_GCVIT_TRAIN, DETR_GCVIT_VALID = 64, 16
DETR_GCVIT_STEPS = DETR_GCVIT_TRAIN // DETR_GCVIT_BATCH
# COCO's 80 category ids: 1 to 90 with ten gaps
COCO_CATEGORY_IDS = [i for i in range(1, 91)
                     if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
_DETR_GCVIT_HEAD = {
    "num_classes": 80, "bg_cls_weight": 0.1, "sync_cls_avg_factor": False,
    "transformer": {
        "type": "Transformer",
        "encoder": {"type": "DetrTransformerEncoder", "num_layers": 6,
                    "transformerlayers": {
                        "type": "BaseTransformerLayer",
                        "attn_cfgs": [{"type": "MultiheadAttention", "embed_dims": 256,
                                       "num_heads": 8, "dropout": 0.1}],
                        "feedforward_channels": 2048, "ffn_dropout": 0.1,
                        "operation_order": ["self_attn", "norm", "ffn", "norm"]}},
        "decoder": {"type": "DetrTransformerDecoder", "return_intermediate": True,
                    "num_layers": 6,
                    "transformerlayers": {
                        "type": "DetrTransformerDecoderLayer",
                        "attn_cfgs": {"type": "MultiheadAttention", "embed_dims": 256,
                                      "num_heads": 8, "dropout": 0.1},
                        "feedforward_channels": 2048, "ffn_dropout": 0.1,
                        "operation_order": ["self_attn", "norm", "cross_attn", "norm", "ffn",
                                            "norm"]}}},
    "positional_encoding": {"type": "SinePositionalEncoding", "num_feats": 128,
                            "normalize": True},
    "train_cfg": {"assigner": {"type": "HungarianAssigner",
                               "cls_cost": {"type": "ClassificationCost", "weight": 1.0},
                               "reg_cost": {"type": "BBoxL1Cost", "weight": 5.0,
                                            "box_format": "xywh"},
                               "iou_cost": {"type": "IoUCost", "iou_mode": "giou",
                                            "weight": 2.0}}},
    "test_cfg": {"max_per_img": 100},
}
_COCO_TRANSFORM = [
    {"name": "FitResize", "params": {"max_height": 400, "max_width": 672}},
    {"name": "Normalize"},
    {"name": "PadIfNeeded", "params": {"min_height": 400, "min_width": 672, "border_mode": 0,
                                       "value": 0}},
    {"name": "ToTensorV2"},
]


def _coco_data(data_folder, train):
    dataset = {"name": "COCODetection",
               "params": {"train": train, "download": True, "data_folder": data_folder,
                          "input_dtype": "bfloat16", "bbox_dtype": "bfloat16",
                          "image_format": "rgb"},
               "transform": copy.deepcopy(_COCO_TRANSFORM)}
    if train:
        dataset["augment"] = [{"name": "HorizontalFlip"}]
    return [{"dataloader": {"batch_size": DETR_GCVIT_BATCH, "num_workers": 8,
                            "drop_last": False, "shuffle": train},
             "dataset": dataset}]


def _coco_meter(tag, iou_thr):
    return {"name": "MMDetectionMAP", "tag": tag,
            "params": {"iou_thr": iou_thr, "num_classes": 80},
            "mapping": {"preds": "prediction", "target": "target"}, "phases": ["VALID", "TEST"]}


def detr_gcvit_config(data_folder: str, log_dir: str) -> dict:
    """The recipe of ``configs/detection/detr_gcvit-t_coco.yaml`` but for
    ``pretrained: false`` (no weights in the repository), its
    ``data_folder``, a CSVLogger and the checkpoints under ``log_dir`` (the
    card machine has no tensorboardX) and a short budget: one epoch over the
    DETR_GCVIT_TRAIN images of ``data_folder``'s COCO tree, one validation."""
    return {
        "task": {"name": "SingleStageDetectionTask",
                 "params": {"backbone_name": "gcvit_tiny",
                            "backbone_params": {"pretrained": False, "in_channels": 3},
                            "num_scales": 1, "head_name": "DETRHead",
                            "head_params": copy.deepcopy(_DETR_GCVIT_HEAD),
                            "inputs": [{"shape": [3, *DETR_GCVIT_SIZE],
                                        "dtype": "bfloat16"}]}},
        "joint_loss": {"normalize_weights": False, "losses": copy.deepcopy(DETR_LOSSES)},
        "optimization": [{"optimizer": {"name": "AdamW",
                                        "params": {"lr": 0.0001, "weight_decay": 0.05},
                                        "paramwise_cfg": {
                                            "bias_lr_mult": 2.0, "bias_decay_mult": 0.0,
                                            "custom_keys": {"backbone": {"lr_mult": 0.1,
                                                                         "decay_mult": 0.002}}}},
                          "scheduler": {"name": "MultiStepLR", "params": {"milestones": [20]}}}],
        "data": {"TRAIN": _coco_data(data_folder, True),
                 "VALID": _coco_data(data_folder, False)},
        "trainer": {"accelerator": "auto", "max_epochs": 1, "precision": "bf16",
                    "num_sanity_val_steps": 2},
        "logger": {"name": "CSVLogger", "experiment_name": "coco_detection",
                   "log_dir": log_dir, "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}"},
        "callbacks": [{"name": "ModelCheckpoint",
                       "params": {"dirpath": os.path.join(log_dir, "ckpt"),
                                  "monitor": "valid/MMDetMAP_50", "save_top_k": 1,
                                  "save_last": True, "mode": "max",
                                  "save_weights_only": False}},
                      {"name": "FinalizeLogger"},
                      {"name": "TQDMProgressBar", "params": {"refresh_rate": 200}}],
        "metrics": [_coco_meter("MMDetMAP_50", 0.5), _coco_meter("MMDetMAP_75", 0.75),
                    {"name": "CocoEvalMAP", "tag": "CEMAP",
                     "params": {"compute_on_step": False,
                                "displayed_metrics": ["map", "map_small", "map_medium",
                                                      "map_large"]},
                     "mapping": {"preds": "prediction", "target": "target"},
                     "phases": ["VALID", "TEST"]}],
    }


def write_coco_tree(root, splits=None):
    """A COCO-format tree under ``root/COCO``: ``annotations/instances_<split>
    .json`` and ``<split>/<id>.png`` for each (split, images, seed). Image
    sides are drawn from 300 to 800 (FitResize and PadIfNeeded both work),
    1 to 12 boxes an image of COCO's 80 gapped category ids, one annotation
    in twelve ``iscrowd`` (the reader skips it) and one image without
    annotations."""
    import json
    import numpy as np
    from torchok_tpu_torch.native import encode_png

    coco = os.path.join(root, "COCO")
    os.makedirs(os.path.join(coco, "annotations"), exist_ok=True)
    splits = splits or (("train2017", DETR_GCVIT_TRAIN, 3), ("val2017", DETR_GCVIT_VALID, 4))
    for split, n, seed in splits:
        os.makedirs(os.path.join(coco, split), exist_ok=True)
        rng = np.random.default_rng(seed)
        images, annotations = [], []
        for i in range(n):
            h, w = (int(v) for v in rng.integers(300, 801, 2))
            img = np.repeat(np.repeat(rng.integers(0, 90, (h // 8 + 1, w // 8 + 1, 3),
                                                   dtype=np.uint8), 8, 0), 8, 1)[:h, :w]
            image_id = 1000 + i
            for _ in range(0 if i == n - 1 else int(rng.integers(1, 13))):
                bw, bh = (int(v) for v in np.exp(rng.uniform(np.log(12), np.log(0.9 * min(h, w)),
                                                             2)))
                x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
                k = int(rng.integers(0, 80))
                img[y0:y0 + bh, x0:x0 + bw] = (40 + 2 * k, 200 - 2 * k, 120 + k)
                annotations.append({"id": len(annotations) + 1, "image_id": image_id,
                                    "category_id": COCO_CATEGORY_IDS[k],
                                    "bbox": [x0, y0, bw, bh], "area": bw * bh,
                                    "iscrowd": int(len(annotations) % 12 == 5)})
            name = f"{image_id:012d}.png"
            with open(os.path.join(coco, split, name), "wb") as f:
                f.write(encode_png(img))
            images.append({"id": image_id, "file_name": name, "height": h, "width": w})
        categories = [{"id": cid, "name": f"class_{cid}", "supercategory": "none"}
                      for cid in COCO_CATEGORY_IDS]
        with open(os.path.join(coco, "annotations", f"instances_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)


# configs/detection/fcos_vit-s_coco.yaml's model at full width under its
# FreezeUnfreeze, through the COCO pipeline of detr_gcvit_config
FCOS_VIT_SIZE = (400, 672)
FCOS_VIT_TRAIN, FCOS_VIT_VALID = 64, 16
FCOS_VIT_STEPS = FCOS_VIT_TRAIN // 8


def fcos_vit_config(data_folder: str, log_dir: str) -> dict:
    """The recipe of ``configs/detection/fcos_vit-s_coco.yaml`` but for
    ``pretrained: false`` (no weights in the repository), its
    ``data_folder``, bf16 boxes, a CSVLogger and ModelCheckpoint under
    ``log_dir`` (no tensorboardX on the card machine) and a short budget:
    one epoch over the FCOS_VIT_TRAIN images of the COCO tree, one
    validation; FreezeUnfreeze and ModelCheckpoint as the recipe sets them."""
    cfg = fcos_r50_config(data_folder)
    params = cfg["task"]["params"]
    params["backbone_name"] = "vit_small_patch16_224"
    params["inputs"] = [{"shape": [3, *FCOS_VIT_SIZE], "dtype": "bfloat16"}]
    cfg["optimization"][0]["optimizer"]["paramwise_cfg"] = {"bias_lr_mult": 2.0,
                                                            "bias_decay_mult": 0.0}
    cfg["data"] = {"TRAIN": _coco_data(data_folder, True), "VALID": _coco_data(data_folder, False)}
    cfg["trainer"]["num_sanity_val_steps"] = 2
    cfg["logger"] = {"name": "CSVLogger", "experiment_name": "coco_detection",
                     "log_dir": log_dir, "timestamp": "${now:%Y-%m-%d}/${now:%H-%M-%S}"}
    cfg["callbacks"] = [{"name": "ModelCheckpoint",
                         "params": {"dirpath": os.path.join(log_dir, "ckpt"),
                                    "monitor": "valid/MMDetMAP_50", "save_top_k": 1,
                                    "save_last": True, "mode": "max",
                                    "save_weights_only": False}},
                        {"name": "FreezeUnfreeze",
                         "params": {"freeze_modules": [{"module_name": "backbone",
                                                        "stages": 1}]}}]
    return cfg


TRAIN_STEPS = 6
BATCHES = 3
BLOCKS = (2, 2, 6, 2)  # SwinBlocks per stage of swinv2_tiny
# (Hp, Wp, C, heads) of each stage at 256x256 input; window 8, head dim 32
STAGES = ((64, 64, 96, 3), (32, 32, 192, 6), (16, 16, 384, 12), (8, 8, 768, 24))
# SwinV2 models whose K1/K2 are held and timed at their stage shapes: (batch,
# stages of (Hp, Wp, C, heads, ws, blocks)) at each model's input size (256,
# 256, 192, 384); a window shrinks to a map no larger than it. L = ws * ws:
# 64; 256 and 64; 144 and 36; 576 (in f32 the key-tiled path) and 144.
SWIN_MODELS = {
    "swinv2_tiny_window8_256": (128, ((64, 64, 96, 3, 8, 2), (32, 32, 192, 6, 8, 2),
                                      (16, 16, 384, 12, 8, 6), (8, 8, 768, 24, 8, 2))),
    "swinv2_tiny_window16_256": (128, ((64, 64, 96, 3, 16, 2), (32, 32, 192, 6, 16, 2),
                                       (16, 16, 384, 12, 16, 6), (8, 8, 768, 24, 8, 2))),
    "swinv2_base_window12_192_22k": (128, ((48, 48, 128, 4, 12, 2), (24, 24, 256, 8, 12, 2),
                                           (12, 12, 512, 16, 12, 18), (6, 6, 1024, 32, 6, 2))),
    "swinv2_base_window12to24_192to384_22kft1k": (32, ((96, 96, 128, 4, 24, 2),
                                                       (48, 48, 256, 8, 24, 2),
                                                       (24, 24, 512, 16, 24, 18),
                                                       (12, 12, 1024, 32, 12, 2))),
}
RECORD_MODEL = "swinv2_tiny_window8_256"  # K1/K2's JSON records sum its blocks
CHECK_BATCH = 8
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# K2's tolerances are relative to the largest magnitude of the reference
# tensor. dqkv is rounded to the input dtype (one bf16 ulp is 2^-8 relative).
# dbias and dscale are f32 sums of f32 terms over up to 8,192 windows in both
# versions, in another order, so they differ by f32 rounding only even for
# bf16 inputs; many terms cancel, hence 1e-3 rather than 1e-4 of the maximum.
K2_TOLERANCE = {"float32": {"dqkv": 1e-4, "dbias": 1e-3, "dscale": 1e-3},
                "bfloat16": {"dqkv": 2e-2, "dbias": 1e-3, "dscale": 1e-3}}
TIMING_ITERS = 10
TIMING_ITERS_SMALL = 5

# gcvit_tiny at 224x224: (Hp, Wp, C, heads, ws, local blocks, global blocks)
# of each stage; head dim 32. Blocks alternate local (even) and global (odd).
GCVIT_STAGES = ((56, 56, 64, 2, 7, 2, 1), (28, 28, 128, 4, 7, 2, 2),
                (14, 14, 256, 8, 14, 10, 9), (7, 7, 512, 16, 7, 3, 2))
# davit_t at 224x224: (Hp, Wp, C, heads, ws, spatial blocks); no bias
DAVIT_STAGES = ((56, 56, 96, 3, 7, 1), (28, 28, 192, 6, 7, 1),
                (14, 14, 384, 12, 7, 3), (7, 7, 768, 24, 7, 1))
# the plain modes' tensor-core forward kernels in a build (mangled names:
# swin_fwd_kernel<., ., kCosine false, ...> and the global window walk)
PLAIN_FWD_MMA = r"swin_fwd_kernelILi\dELi\dELb0E|global_fwd_kernel"
# gcvit_tiny at 400x672 (configs/detection/detr_gcvit-t_coco.yaml): stage
# maps 100x168, 50x84, 25x42 and 13x21 padded up to the window
GCVIT_400X672_STAGES = ((105, 168, 64, 2, 7, 2, 1), (56, 84, 128, 4, 7, 2, 2),
                        (28, 42, 256, 8, 14, 10, 9), (14, 21, 512, 16, 7, 3, 2))
GCVIT_LOCAL = sum(st[5] for st in GCVIT_STAGES)    # 17 K3 launches per forward
GCVIT_GLOBAL = sum(st[6] for st in GCVIT_STAGES)   # 14 K4 launches per forward
DAVIT_SPATIAL = sum(st[5] for st in DAVIT_STAGES)  # 6 K3 launches per forward
# K3b/K5 tolerances, relative to the largest magnitude of the reference
# tensor. dqkv/dkv are rounded to the input dtype (one bf16 ulp is 2^-8
# relative). dqg and dbias are f32 sums of f32 terms in both versions, in
# another order; in bf16 the two versions round a few dls entries to
# neighbouring bf16 values (their f32 dl differ in the last bits), and each
# such entry moves dqg by a bf16 ulp (2^-8) of its term, hence 2^-8 of the
# largest entry there (1.3e-3 to 6.4e-4 of it were seen).
DOT_BWD_TOLERANCE = {"float32": {"dqkv": 1e-4, "dkv": 1e-4, "dqg": 1e-4, "dbias": 1e-3},
                     "bfloat16": {"dqkv": 2e-2, "dkv": 2e-2, "dqg": 2.0 ** -8, "dbias": 1e-3}}


_START = time.perf_counter()


def stamp(label: str) -> None:
    """The script's seconds so far, before ``label``'s phase."""
    print(f"[{time.perf_counter() - _START:.1f} s] {label}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b, hp, wp, c, heads, ws, dtype, masked, seed):
    import torch
    from torchok_tpu_torch.models.backbones.swin import shift_window_mask
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    L = ws * ws
    qkv = (0.5 * torch.randn((b, hp, wp, 3 * c), generator=g, device=dev)).to(dtype)
    logit_scale = math.log(10.0) + 0.5 * torch.randn((heads,), generator=g, device=dev)
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    bias = 16 * torch.sigmoid(torch.randn((heads, L, L), generator=g, device=dev))
    mask = shift_window_mask(hp, wp, ws, ws // 2).to(dev) if masked else None
    return qkv, scale, bias, mask


def sdpa_inputs(qkv, scale, bias, mask, heads, ws):
    """The closest single library call, on what it needs prepared: windows
    already partitioned, q and k already normalised, q already scaled, and
    bias (+ mask) as one additive ``attn_mask``. The (window, head) pairs
    ride the head axis so the mask broadcasts over the images."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops.swin_attention import to_windows
    q, k, v = to_windows(qkv, ws, 3, heads)  # (B, H, nW, L, D)
    q = F.normalize(q.float(), dim=-1) * scale.view(1, heads, 1, 1, 1)
    k = F.normalize(k.float(), dim=-1)
    b, _, nw, L, d = q.shape
    attn = bias.view(heads, 1, L, L)
    if mask is not None:
        attn = attn + mask.view(1, nw, L, L)
    attn = attn.expand(heads, nw, L, L).reshape(1, heads * nw, L, L).to(qkv.dtype).contiguous()
    q, k, v = (t.reshape(b, heads * nw, L, d).to(qkv.dtype).contiguous() for t in (q, k, v))
    return q, k, v, attn


def attention_cost(b, hp, wp, c, heads, ws, itemsize, backward, masked):
    """Bytes the function must move (each input read once, each output
    written once) and the operations of its products on these inputs."""
    tokens, L = b * hp * wp, ws * ws
    small = 4 * (heads + heads * L * L + (hp // ws) * (wp // ws) * L * L * masked)
    if backward:  # qkv and dout in, dqkv out, dbias and dscale out; five products
        return 7 * c * itemsize * tokens + small + 4 * (heads * L * L + heads), \
            5 * 2 * tokens * L * c
    return 4 * c * itemsize * tokens + small, 2 * 2 * tokens * L * c


# published dense peaks of the H100 SXM: device memory 3.35 TB/s; 989 TFLOP/s
# for bf16 operands, 67 TFLOP/s for f32 operands outside the tensor cores
MEMORY_RATE = 3.35e12
PEAK_RATE = {"bfloat16": 989e12, "float32": 67e12}


def bound_ms(nbytes, flops, dtype_name):
    by_bytes = 1e3 * nbytes / MEMORY_RATE
    by_ops = 1e3 * flops / PEAK_RATE[dtype_name]
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def shape_cases(batch):
    """(stage, (hp, wp, c, heads), masked, blocks of that kind per forward)."""
    for stage, ((hp, wp, c, heads), depth) in enumerate(zip(STAGES, BLOCKS), 1):
        for masked in ((False, True) if hp > 8 else (False,)):
            yield stage, (hp, wp, c, heads), masked, depth // 2 if hp > 8 else depth


def swin_cases(model):
    """(stage, (hp, wp, c, heads, ws), masked, blocks of that kind per
    forward) of one SwinV2 model: a stage whose map is larger than its
    window shifts every other block."""
    _, stages = SWIN_MODELS[model]
    for stage, (hp, wp, c, heads, ws, depth) in enumerate(stages, 1):
        shifted = hp > ws
        for masked in ((False, True) if shifted else (False,)):
            yield stage, (hp, wp, c, heads, ws), masked, depth // 2 if shifted else depth


def check_swin(backward: bool):
    """K1 (``backward`` False) or K2 against its plain version at every stage
    shape of the SwinV2 models of ``SWIN_MODELS`` (windows 6 to 24, L 36 to
    576), batch 8 in f32 (TF32 off) and each model's batch in bf16, K2 twice
    for bit equality; at the model's batch the kernel, the plain version and
    SDPA are timed beside the bound. Prints the sums over each model's
    forward (K1) or backward (K2); the record sums swinv2_tiny_window8_256's,
    as before the other windows ran."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import swin_attention as ops
    kind = "K2" if backward else "K1"
    names = ("dqkv", "dbias", "dscale")
    failures = []
    worst_bf16 = 0.0
    sums = {}

    def run(fn, args, dout, ws, heads):
        return fn(*args, dout, ws, heads) if backward else (fn(*args, ws, heads),)

    kernel = ops.swin_attention_bwd_cuda if backward else ops.swin_attention_fwd_cuda
    plain = ops.swin_attention_bwd_plain if backward else ops.swin_attention_fwd_plain
    for model, (batch, _) in SWIN_MODELS.items():
        total = sums.setdefault(model, {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0,
                                        "n": 0})
        for dtype, b in ((torch.float32, CHECK_BATCH), (torch.bfloat16, batch)):
            name = dtype_name(dtype)
            for stage, (hp, wp, c, heads, ws), masked, n in swin_cases(model):
                seed = 10 * stage + masked + (0 if b == CHECK_BATCH else 100)
                args = attention_inputs(b, hp, wp, c, heads, ws, dtype, masked, seed)
                g = torch.Generator(device="cuda")
                g.manual_seed(1000 + seed)
                dout = torch.randn((b, hp, wp, c), generator=g, device="cuda").to(dtype)
                got = run(kernel, args, dout, ws, heads)
                again = run(kernel, args, dout, ws, heads)
                ref = run(plain, args, dout, ws, heads)
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b_) for a, b_ in zip(got, again))
                ok = ok and all(bool(torch.isfinite(t).all().item()) for t in got)
                parts = []
                for key, g_, r_ in zip(names if backward else ("out",), got, ref):
                    err = (g_.float() - r_.float()).abs().max().item()
                    if backward:
                        rel = K2_TOLERANCE[name][key]
                        mag = r_.float().abs().max().item()
                        ok = ok and err <= rel * mag
                        parts.append(f"{key} err={err:.3e} (tol {rel:g} x max|ref| {mag:.3e})")
                    else:
                        ok = ok and err <= TOLERANCE[name]
                        parts.append(f"max_abs_err={err:.3e} (tol {TOLERANCE[name]:g})")
                    if name == "bfloat16" and key in ("out", "dqkv"):
                        worst_bf16 = max(worst_bf16, err)
                del got, again, ref
                line = (f"{kind} {name} {model} B{b} stage{stage} qkv=({b},{hp},{wp},{3 * c}) "
                        f"heads={heads} ws={ws} L={ws * ws} mask={masked} x{n}: "
                        + ", ".join(parts) + ", bit-equal twice")
                if b == batch:
                    k_ms = median_ms(lambda: run(kernel, args, dout, ws, heads), TIMING_ITERS)
                    p_ms = median_ms(lambda: run(plain, args, dout, ws, heads),
                                     TIMING_ITERS_SMALL)
                    q, k, v, attn = sdpa_inputs(*args, heads, ws)
                    if backward:
                        for t in (q, k, v):
                            t.requires_grad_(True)
                        dwin = torch.randn_like(q)

                        def library():
                            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn,
                                                                 scale=1.0)
                            torch.autograd.grad(out, (q, k, v), dwin)
                    else:
                        def library():
                            F.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=1.0)
                    lib_ms = median_ms(library, TIMING_ITERS_SMALL)
                    del q, k, v, attn
                    nbytes, flops = attention_cost(b, hp, wp, c, heads, ws, 2, backward, masked)
                    b_ms, by = bound_ms(nbytes, flops, "bfloat16")
                    line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                             f"sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f} "
                             f"bound_ms={b_ms:.4f} ({by})")
                    for key, value in (("k", k_ms), ("p", p_ms), ("lib", lib_ms),
                                       ("bytes", nbytes), ("flops", flops), ("n", 1)):
                        total[key] += n * value
                print(line, flush=True)
                if not ok:
                    failures.append(line)
                del args, dout
    if failures:
        fail(f"{kind} disagrees with its plain version or with itself: " + "; ".join(failures))
    for model, t in sums.items():
        b_ms, by = bound_ms(t["bytes"], t["flops"], "bfloat16")
        print(f"{kind} bf16 bs{SWIN_MODELS[model][0]} per {'backward' if backward else 'forward'}"
              f" of {model} ({t['n']} blocks): kernel_ms={t['k']:.4f} plain_ms={t['p']:.4f} "
              f"sdpa{'_fwd_bwd' if backward else ''}_ms={t['lib']:.4f} bound_ms={b_ms:.4f} "
              f"({by}: {t['bytes'] / 1e9:.3f} GB, {t['flops'] / 1e9:.1f} GFLOP)", flush=True)
    t = sums[RECORD_MODEL]
    total_bound, bound_by = bound_ms(t["bytes"], t["flops"], "bfloat16")
    source = ops.KERNEL_BWD if backward else ops.KERNEL
    return {"name": source, "route": "cuda",
            "source": f"torchok_tpu_torch/csrc/{source}.cu",
            "replaces": f"torchok_tpu/ops/swin_attention.py:{159 if backward else 93}",
            "launches": 0, "max_abs_err": worst_bf16,
            "ms": t["k"], "plain_ms": t["p"], "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": t["lib"]}


def check_k1():
    return check_swin(False)


def check_k2():
    return check_swin(True)


def dot_inputs(b, hp, wp, c, heads, ws, dtype, parts, with_bias, seed):
    """(proj, qg or None, scale, bias or None, dout) on the card for the plain
    window attention kernels; ``parts`` 3 is qkv, 2 is kv with global queries."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    L = ws * ws
    proj = torch.randn((b, hp, wp, parts * c), generator=g, device=dev).to(dtype)
    qg = torch.randn((b, L, c), generator=g, device=dev).to(dtype) if parts == 2 else None
    scale = torch.full((heads,), 32 ** -0.5, device=dev)
    bias = torch.randn((heads, L, L), generator=g, device=dev) if with_bias else None
    dout = torch.randn((b, hp, wp, c), generator=g, device=dev).to(dtype)
    return proj, qg, scale, bias, dout


def dot_sdpa_inputs(proj, qg, bias, ws, heads):
    """The closest single library call on what it needs prepared: windows
    already partitioned (and for the global mode the queries already repeated
    over the windows), bias as an additive ``attn_mask``; SDPA's default scale
    is the kernels' head_dim**-0.5."""
    from torchok_tpu_torch.ops.swin_attention import to_windows
    if qg is None:
        q, k, v = to_windows(proj, ws, 3, heads)  # (B, H, nW, L, D)
    else:
        k, v = to_windows(proj, ws, 2, heads)
        b, _, _, L, d = k.shape
        q = qg.reshape(b, L, heads, d).permute(0, 2, 1, 3)[:, :, None].expand_as(k)
    b, _, nw, L, d = k.shape
    attn = None
    if bias is not None:
        attn = bias.view(heads, 1, L, L).expand(heads, nw, L, L)
        attn = attn.reshape(1, heads * nw, L, L).to(proj.dtype).contiguous()
    q, k, v = (t.reshape(b, heads * nw, L, d).contiguous() for t in (q, k, v))
    return q, k, v, attn


def dot_cost(kind, b, hp, wp, c, heads, ws, itemsize, with_bias):
    """Bytes each kernel must move (each input read once, each output written
    once) and the operations of its products."""
    tokens, L = b * hp * wp, ws * ws
    small = 4 * heads * L * L * with_bias
    if kind == "K3a":
        return itemsize * tokens * 4 * c + small + 4 * heads, 4 * tokens * L * c
    if kind == "K3b":
        return itemsize * tokens * 7 * c + 2 * small + 4 * heads, 10 * tokens * L * c
    if kind == "K4":
        return itemsize * (tokens * 3 * c + b * L * c) + small + 4 * heads, 4 * tokens * L * c
    return (itemsize * (tokens * 5 * c + b * L * c) + 4 * b * L * c + 2 * small + 4 * heads,
            10 * tokens * L * c)


_DOT = {
    # kind: (wrapper, plain, source, replaces, parts, backward, output names)
    "K3a": ("window_attention_fwd_cuda", "window_attention_fwd_plain", "window_attention_fwd",
            "torchok_tpu/ops/swin_attention.py:93", 3, False, ("out",)),
    "K3b": ("window_attention_bwd_cuda", "window_attention_bwd_plain", "window_attention_bwd",
            "torchok_tpu/ops/swin_attention.py:159", 3, True, ("dqkv", "dbias")),
    "K4": ("window_attention_global_fwd_cuda", "window_attention_global_fwd_plain",
           "window_attention_global_fwd", "torchok_tpu/ops/swin_attention.py:267", 2, False,
           ("out",)),
    "K5": ("window_attention_global_bwd_cuda", "window_attention_global_bwd_plain",
           "window_attention_global_bwd", "torchok_tpu/ops/swin_attention.py:294", 2, True,
           ("dkv", "dqg", "dbias")),
}


def check_dot(kind, cases, timing=True):
    """One plain window attention kernel against its plain version at every
    shape in ``cases`` = [(label, (hp, wp, c, heads, ws), with_bias, launches
    per forward or backward of its model, counts towards the record)], in f32
    at B 8 and bf16 at B 128, twice for bit equality, with the route each
    launch took (bf16 on the tensor cores, f32 on the FMA template). Returns
    the JSON record, whose times are summed over the cases that count."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import window_attention_dot as dot
    wrapper_name, plain_name, source, replaces, parts, backward, names = _DOT[kind]
    wrapper, plain = getattr(dot, wrapper_name), getattr(dot, plain_name)
    route_of, counter = ((dot.backward_route, dot.ROUTE_LAUNCHES) if backward
                         else (dot.forward_route, dot.FWD_ROUTE_LAUNCHES))
    failures = []
    worst_bf16 = 0.0
    total = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0, "launches": 0}
    by_model = {}

    def call(fn, proj, qg, scale, bias, dout, ws, heads):
        args = (proj,) + ((qg,) if parts == 2 else ()) + (scale, bias)
        out = fn(*args, *((dout,) if backward else ()), ws, heads)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(t for t in out if t is not None)

    for dtype, default_batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, 128)):
        name = str(dtype).split(".")[-1]
        for idx, (label, (hp, wp, c, heads, ws), with_bias, n, counts, *own) in \
                enumerate(cases):
            batch = own[0] if own else default_batch
            inputs = dot_inputs(batch, hp, wp, c, heads, ws, dtype, parts, with_bias, 20 + idx)
            before = dict(counter)
            got = call(wrapper, *inputs, ws, heads)
            again = call(wrapper, *inputs, ws, heads)
            routed = {k: v - before.get(k, 0) for k, v in counter.items()
                      if v != before.get(k, 0)}
            ref = call(plain, *inputs, ws, heads)
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(got, again))
            # bf16 on the tensor cores, f32 on the FMA template
            route = route_of(source, dtype)
            want = "mma" if dtype == torch.bfloat16 else "templates"
            ok = ok and route == want and routed == {(source, route): 2}
            ok = ok and all(bool(torch.isfinite(t).all().item()) for t in got)
            parts_txt = []
            for key, g, r in zip((k for k in names if with_bias or k != "dbias"), got, ref):
                err = (g.float() - r.float()).abs().max().item()
                if backward:
                    rel = DOT_BWD_TOLERANCE[name][key]
                    mag = r.float().abs().max().item()
                    ok = ok and err <= rel * mag
                    parts_txt.append(f"{key} err={err:.3e} (tol {rel:g} x max|ref| {mag:.3e})")
                else:
                    ok = ok and err <= TOLERANCE[name]
                    parts_txt.append(f"max_abs_err={err:.3e} (tol {TOLERANCE[name]:g})")
                if name == "bfloat16" and key in ("out", "dqkv", "dkv"):
                    worst_bf16 = max(worst_bf16, err)
            del got, again, ref
            width = parts * c
            line = (f"{kind} {name} B{batch} {label} proj=({batch},{hp},{wp},{width}) "
                    f"heads={heads} ws={ws} bias={with_bias} x{n} route {route}: "
                    + ", ".join(parts_txt) + ", bit-equal twice")
            if timing:
                iters = TIMING_ITERS if dtype == torch.bfloat16 else TIMING_ITERS_SMALL
                k_ms = median_ms(lambda: call(wrapper, *inputs, ws, heads), iters)
                p_ms = median_ms(lambda: call(plain, *inputs, ws, heads), iters)
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
                if dtype == torch.bfloat16:
                    proj, qg, _, bias, _ = inputs
                    q, k, v, attn = dot_sdpa_inputs(proj, qg, bias, ws, heads)
                    if backward:
                        for t in (q, k, v):
                            t.requires_grad_(True)
                        dwin = torch.randn_like(q)

                        def library():
                            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn)
                            torch.autograd.grad(out, (q, k, v), dwin)
                    else:
                        def library():
                            F.scaled_dot_product_attention(q, k, v, attn_mask=attn)
                    lib_ms = median_ms(library, iters)
                    nbytes, flops = dot_cost(kind, batch, hp, wp, c, heads, ws, 2, with_bias)
                    b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
                    line += (f" sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f} "
                             f"bound_ms={b_ms:.4f}")
                    model = label.split()[0]
                    sums = by_model.setdefault(model, [0.0, 0.0, 0.0, 0])
                    for i, v_ in enumerate((n * k_ms, n * p_ms, n * lib_ms, n)):
                        sums[i] += v_
                    if counts:
                        total["k"] += n * k_ms
                        total["p"] += n * p_ms
                        total["lib"] += n * lib_ms
                    del q, k, v, attn
            if dtype == torch.bfloat16 and counts:
                nbytes, flops = dot_cost(kind, batch, hp, wp, c, heads, ws, 2, with_bias)
                total["bytes"] += n * nbytes
                total["flops"] += n * flops
                total["launches"] += n
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del inputs
    if failures:
        fail(f"{kind} disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total["bytes"], total["flops"], "bfloat16")
    for model, (k_ms, p_ms, lib_ms, n) in by_model.items():
        print(f"{kind} bf16 per {'backward' if backward else 'forward'} of {model} "
              f"({n} launches): kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"sdpa{'_fwd_bwd' if backward else ''}_ms={lib_ms:.4f}", flush=True)
    print(f"{kind} record ({total['launches']} launches of gcvit_tiny): "
          f"bound_ms={total_bound:.4f} ({bound_by}: {total['bytes'] / 1e9:.3f} GB, "
          f"{total['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": source, "route": "cuda", "source": f"torchok_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": worst_bf16,
            "ms": total["k"], "plain_ms": total["p"], "bound_ms": total_bound,
            "bound_by": bound_by, "library_ms": total["lib"] if timing else None,
            "dtype_routes": {dtype_name(t): route_of(source, t)
                             for t in (torch.bfloat16, torch.float32)}}


def gcvit_cases(column):
    """GCViT-tiny's stage shapes with the launches of one kind per forward
    (``column`` 5: local blocks, 6: global blocks); these make the record.
    Then its padded stage maps at the DETR recipe's 400x672 (non-square,
    ``GCVIT_400X672_STAGES``) at its batch of 8 in both dtypes."""
    return [(f"gcvit_tiny stage{i}", st[:5], True, st[column], True)
            for i, st in enumerate(GCVIT_STAGES, 1)] + \
        [(f"gcvit_tiny_400x672 stage{i}", st[:5], True, st[column], False, DETR_GCVIT_BATCH)
         for i, st in enumerate(GCVIT_400X672_STAGES, 1)]


def check_k3(timing=True):
    """K3a and K3b at GCViT-tiny's local shapes (with the bias; at 224x224
    and 400x672) and DaViT-t's (without); the records sum GCViT-tiny's 17
    launches at 224x224."""
    cases = gcvit_cases(5) + [(f"davit_t stage{i}", st[:5], False, st[5], False)
                              for i, st in enumerate(DAVIT_STAGES, 1)]
    return check_dot("K3a", cases, timing), check_dot("K3b", cases, timing)


def check_k4(timing=True):
    return check_dot("K4", gcvit_cases(6), timing)


def check_k5(timing=True):
    return check_dot("K5", gcvit_cases(6), timing)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def mw_inputs(b_, heads, n_mask, dtype, seed):
    """(q, k, v, logit_scale, bias, mask) on the card for K6: L 64, D 32;
    ``n_mask`` window types (0: no mask)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    q, k, v = ((0.5 * torch.randn((b_, heads, 64, 32), generator=g, device=dev)).to(dtype)
               for _ in range(3))
    logit_scale = math.log(10.0) + 0.5 * torch.randn((heads,), generator=g, device=dev)
    bias = 16 * torch.sigmoid(torch.randn((heads, 64, 64), generator=g, device=dev))
    mask = None
    if n_mask:
        mask = -100.0 * (torch.rand((n_mask, 64, 64), generator=g, device=dev) < 0.3).float()
    return q, k, v, logit_scale, bias, mask


# K6's one-ulp check: each bf16 output within one bf16 ulp of the plain
# version's, the ulp taken at the larger magnitude of the two but at no less
# than ULP_FLOOR x max|v|. Below that floor the f32 roundings of both (a few
# f32 ulps of a logit at a temperature of up to 100: about 1e-5 of an output's
# scale max|v|) exceed an output's own ulp in either version. Rounding the
# weights or the unit vectors to bf16 moves outputs by 2^-9 of that scale or
# more, and fails it.
ULP_FLOOR = 2.0 ** -7


def outside_one_ulp(got, ref, v) -> int:
    """How many elements of ``got`` lie more than one bf16 ulp from ``ref``
    (both bf16 of one shape), the ulp as above with v the values attended
    over."""
    import torch
    g, r = got.float(), ref.float()
    floor = ULP_FLOOR * v.float().abs().max()
    size = torch.maximum(torch.maximum(g.abs(), r.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(size)) - 7)
    return int(((g - r).abs() > ulp).sum().item())


def mw_sdpa_inputs(q, k, v, logit_scale, bias, mask):
    """The closest single library call on what it needs prepared: q and k
    already normalised, q already scaled, bias (+ mask) as one additive
    ``attn_mask``; it leaves out the normalisation, the temperature and the
    assembly of the mask. The (window type, head) pairs ride the head axis so
    the mask broadcasts over the images."""
    import torch
    import torch.nn.functional as F
    b_, heads, L, d = q.shape
    nw = 1 if mask is None else mask.shape[0]
    scale = torch.exp(torch.clamp(logit_scale, max=math.log(100.0)))
    qn = F.normalize(q.float(), dim=-1) * scale.view(1, heads, 1, 1)
    kn = F.normalize(k.float(), dim=-1)
    attn = bias[None] if mask is None else bias[None] + mask[:, None]
    attn = attn.reshape(1, nw * heads, L, L).to(q.dtype).contiguous()
    qn, kn, vv = (t.to(q.dtype).reshape(b_ // nw, nw * heads, L, d).contiguous()
                  for t in (qn, kn, v))
    return qn, kn, vv, attn


def mw_cost(b_, heads, n_mask, itemsize):
    L, d = 64, 32
    return (4 * b_ * heads * L * d * itemsize + 4 * (heads + heads * L * L + n_mask * L * L),
            4 * b_ * heads * L * L * d)


# K6's tensor-core kernels mw_mma::mw_fwd_kernel<L, kHasMask>, mangled (not
# the FMA template's window_attention_mw_fwd_kernel)
MW_MMA = r"6mw_mma13mw_fwd_kernel"


def check_k6():
    """K6 against its plain version at swinv2_tiny's window shapes, masked
    (compact, one row per window type) and unmasked, on the route printed
    per stage (bf16 the tensor-core kernel, f32 the FMA template); bf16 also
    within one ulp of the plain version element by element
    (``outside_one_ulp``, which the einsum formulation's bf16 unit vectors
    and weights fail: their count is printed). The record sums the 12 blocks
    of one forward at batch 128."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import window_attention as wa
    failures = []
    worst_bf16 = 0.0
    total = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    for dtype, batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, 128)):
        name = dtype_name(dtype)
        route = wa.forward_route(dtype, 64, 32)
        if route != ("mma" if dtype == torch.bfloat16 else "fma") \
                or wa.library_route(dtype, 64, 32) != route:
            fail(f"K6 {name} at L 64, head dim 32 routes to {route}")
        for stage, (hp, wp, c, heads), masked, n in shape_cases(batch):
            nw = (hp // 8) * (wp // 8)
            args = mw_inputs(batch * nw, heads, nw if masked else 0, dtype, 30 + stage)
            before = wa.FWD_ROUTE_LAUNCHES[route]
            got = wa.window_attention_mw_cuda(*args)
            ref = wa.window_attention_mw_plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and err <= TOLERANCE[name] \
                and wa.FWD_ROUTE_LAUNCHES[route] == before + 1
            ulp = ""
            if dtype == torch.bfloat16:
                outside = outside_one_ulp(got, ref, args[2])
                einsum = outside_one_ulp(wa.window_attention_einsum(*args), ref, args[2])
                ok = ok and outside == 0
                ulp = (f" outside_one_ulp={outside} of {got.numel()} (einsum formulation "
                       f"{einsum})")
            del got, ref
            iters = TIMING_ITERS if batch > CHECK_BATCH else TIMING_ITERS_SMALL
            k_ms = median_ms(lambda: wa.window_attention_mw_cuda(*args), iters)
            p_ms = median_ms(lambda: wa.window_attention_mw_plain(*args), iters)
            line = (f"K6 {name} B{batch} stage{stage} q=({batch * nw},{heads},64,32) "
                    f"mask={masked} x{n} blocks route {route}: max_abs_err={err:.3e} "
                    f"(tol {TOLERANCE[name]:g}){ulp} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
            if batch == 128:
                worst_bf16 = max(worst_bf16, err)
                qn, kn, vv, attn = mw_sdpa_inputs(*args)
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qn, kn, vv, attn_mask=attn, scale=1.0), iters)
                del qn, kn, vv, attn
                nbytes, flops = mw_cost(batch * nw, heads, nw if masked else 0, 2)
                b_ms, _ = bound_ms(nbytes, flops, "bfloat16")
                line += f" sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f}"
                for key, value in (("k", k_ms), ("p", p_ms), ("lib", lib_ms), ("bytes", nbytes),
                                   ("flops", flops)):
                    total[key] += n * value
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del args
    if failures:
        fail("K6 disagrees with its plain version: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(total["bytes"], total["flops"], "bfloat16")
    print(f"K6 bf16 bs128 per forward (12 blocks): kernel_ms={total['k']:.4f} "
          f"plain_ms={total['p']:.4f} sdpa_ms={total['lib']:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {total['bytes'] / 1e9:.3f} GB, {total['flops'] / 1e9:.1f} GFLOP)",
          flush=True)
    return {"name": wa.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/window_attention_mw_fwd.cu",
            "replaces": "torchok_tpu/ops/window_attention.py:88",
            "launches": 0, "max_abs_err": worst_bf16, "ms": total["k"], "plain_ms": total["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": total["lib"]}


# ResNet-50's bottleneck 1x1 convs: (stage, pixels per image, wide, narrow)
BN_STAGES = ((2, 56 * 56, 256, 64), (3, 28 * 28, 512, 128), (4, 14 * 14, 1024, 256),
             (5, 7 * 7, 2048, 512))
RESNET_BATCH = 256
CHAIN_STAGE, CHAIN_LAYERS = 4, 8
# y: f32 sums in another order than the library's, or one bf16 ulp where the
# two f32 sums fall on either side of a rounding boundary, as a fraction of
# the largest |y|
GEMM_TOLERANCE = {"float32": 1e-4, "bfloat16": 2.0 ** -7}


def bn_inputs(m, k, n, dtype, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=g, device=dev) * (2.0 / k) ** 0.5).to(dtype)
    scale = 0.5 + torch.rand((k,), generator=g, device=dev)
    bias = 0.2 * torch.randn((k,), generator=g, device=dev)
    return x, w, scale, bias


def bn_library(x, w, scale, bias, relu_in, with_affine):
    """The unfused chain of library calls: elementwise affine + ReLU, one
    ``torch.matmul``, two column reductions."""
    import torch
    a = x.float()
    if with_affine:
        a = a * scale + bias
    if relu_in:
        a = torch.relu(a)
    y = torch.matmul(a.to(x.dtype), w)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def bn_cost(m, k, n, itemsize):
    return itemsize * (m * k + k * n + m * n) + 4 * (2 * k + 2 * n), 2 * m * k * n


def check_k7():
    """K7 against its plain version, each call on the route its dtype takes
    (bf16 ``wgmma``, f32 ``fma``); the record sums the eight launches of the
    stage-4 chain's forward (four 1024 -> 256, four 256 -> 1024). Each timed
    shape also times the bare bf16 ``torch.matmul(x, w)``: a floor for
    reading x and writing y once, no function K7 computes."""
    import torch
    from torchok_tpu_torch.ops import conv_bn
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}

    def one(label, m, k, n, dtype, flags, seed, timing):
        nonlocal worst_bf16
        name = dtype_name(dtype)
        args = bn_inputs(m, k, n, dtype, seed)
        route = conv_bn.forward_route(dtype, m, k, n)
        before = dict(conv_bn.ROUTE_LAUNCHES)
        got = conv_bn.matmul_bn_cuda(*args, *flags)
        again = conv_bn.matmul_bn_cuda(*args, *flags)
        routes = {r_: conv_bn.ROUTE_LAUNCHES[r_] - before.get(r_, 0) for r_ in conv_bn.ROUTES}
        if route != ("wgmma" if dtype == torch.bfloat16 else "fma") or routes != {
                r_: 2 * (r_ == route) for r_ in conv_bn.ROUTES}:
            fail(f"K7 {name} {label}: expected both launches on the {route} route, got {routes}")
        ref = conv_bn.matmul_bn_plain(*args, *flags)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        top = ref[0].float().abs().max().item()
        err = (got[0].float() - ref[0].float()).abs().max().item()
        ok = same and all(bool(torch.isfinite(t).all().item()) for t in got)
        ok = ok and err <= GEMM_TOLERANCE[name] * top
        # the JAX package's test holds s1/s2 to rtol 1e-4, atol 1e-2 at M <= 256;
        # ulp flips of y and the other summation order are a random walk over
        # the rows, so the atol grows with sqrt(M) (and with |y|)
        atol = 1e-2 * max(1.0, top) * max(1.0, (m / 256) ** 0.5)
        parts = [f"y err={err:.3e} (tol {GEMM_TOLERANCE[name]:g} x max|y| {top:.3e})"]
        for key, g_, r_ in zip(("s1", "s2"), got[1:], ref[1:]):
            excess = ((g_ - r_).abs() - 1e-4 * r_.abs()).max().item()
            ok = ok and excess <= atol
            parts.append(f"{key} err={(g_ - r_).abs().max().item():.3e} of max "
                         f"{r_.abs().max().item():.3e} (rtol 1e-4, atol {atol:.3g})")
        if name == "bfloat16":
            worst_bf16 = max(worst_bf16, err)
        del got, again, ref
        plan = conv_bn.forward_plan(m, k, n, conv_bn._sm_count(args[0].device), route)
        line = (f"K7 {name} {label} x=({m},{k}) w=({k},{n}) relu_in={flags[0]} "
                f"with_affine={flags[1]} route {route} tiles 128x{plan.tile_n} grid "
                f"{plan.tiles_n}x{plan.groups}: " + ", ".join(parts)
                + f", bit-equal twice={same}")
        times = None
        if timing:
            k_ms = median_ms(lambda: conv_bn.matmul_bn_cuda(*args, *flags))
            p_ms = median_ms(lambda: conv_bn.matmul_bn_plain(*args, *flags))
            lib_ms = median_ms(lambda: bn_library(*args, *flags))
            mm_ms = median_ms(lambda: torch.matmul(args[0], args[1]))
            nbytes, flops = bn_cost(m, k, n, args[0].element_size())
            b_ms, by = bound_ms(nbytes, flops, name)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} unfused_ms={lib_ms:.4f} "
                     f"matmul_ms={mm_ms:.4f} bound_ms={b_ms:.4f} ({by})")
            times = (k_ms, p_ms, lib_ms, nbytes, flops)
        print(line, flush=True)
        if not ok:
            failures.append(line)
        return times

    for stage, pixels, wide, narrow in BN_STAGES:
        for k, n in ((wide, narrow), (narrow, wide)):
            one(f"B{CHECK_BATCH} stage{stage}", CHECK_BATCH * pixels, k, n, torch.float32,
                (True, True), stage, False)
            times = one(f"bs{RESNET_BATCH} stage{stage}", RESNET_BATCH * pixels, k, n,
                        torch.bfloat16, (True, True), 10 + stage, True)
            if stage == CHAIN_STAGE:
                for key, value in zip(("k", "p", "lib", "bytes", "flops"), times):
                    record[key] += CHAIN_LAYERS // 2 * value
    _, pixels, wide, narrow = BN_STAGES[CHAIN_STAGE - 2]
    for dtype, batch in ((torch.float32, CHECK_BATCH), (torch.bfloat16, RESNET_BATCH)):
        for flags in ((False, False), (True, False), (False, True)):
            one(f"flags stage{CHAIN_STAGE}", batch * pixels, wide, narrow, dtype, flags, 20, False)
        one("ragged M", batch * pixels - 59, wide, narrow, dtype, (True, True), 21, False)
    if failures:
        fail("K7 disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K7 bf16 bs{RESNET_BATCH} per forward of the stage-{CHAIN_STAGE} chain "
          f"({CHAIN_LAYERS} launches): kernel_ms={record['k']:.4f} plain_ms={record['p']:.4f} "
          f"unfused_ms={record['lib']:.4f} bound_ms={total_bound:.4f} ({bound_by}: "
          f"{record['bytes'] / 1e9:.3f} GB, {record['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": conv_bn.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/matmul_bn_fwd.cu",
            "replaces": "torchok_tpu/ops/conv_bn.py:45",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


# ResNet-50's bottleneck 3x3 convs: (H = W, Cin = Cout)
CONV_SHAPES = ((56, 64), (28, 128), (14, 256), (7, 512))


def conv_inputs(n, h, w_, cin, cout, dtype, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda", 0)
    x = (0.5 * torch.randn((n, h, w_, cin), generator=g, device=dev)).to(dtype)
    w = (0.05 * torch.randn((3, 3, cin, cout), generator=g, device=dev)).to(dtype)
    return x, w


def conv_library_inputs(x, w):
    """NCHW-shaped views of the NHWC data (channels-last memory format) and
    OIHW weights in the same format, for one ``F.conv2d`` call."""
    import torch
    return (x.permute(0, 3, 1, 2),
            w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))


def conv_cost(n, h, w_, cin, cout, itemsize):
    return (itemsize * (n * h * w_ * (cin + cout) + 9 * cin * cout),
            2 * n * h * w_ * 9 * cin * cout)


def check_k8():
    """K8 against its plain version (bf16: its wgmma loop, bit-equal twice;
    a ragged M and Cout 64 and 512 besides ResNet-50's shapes); the record
    sums the four ResNet-50 shapes at batch 256."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import conv_gemm
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    cases = [(f"B{CHECK_BATCH}", (CHECK_BATCH, hw, hw, c, c), torch.float32, False)
             for hw, c in CONV_SHAPES]
    cases += [("odd", (5, 9, 11, 24, 40), torch.float32, False),
              ("odd", (5, 9, 11, 24, 40), torch.bfloat16, False),
              ("ragged M", (3, 13, 11, 64, 128), torch.bfloat16, False),
              ("Cout 64", (2, 10, 10, 128, 64), torch.bfloat16, False),
              ("Cout 512", (2, 7, 7, 256, 512), torch.bfloat16, False)]
    cases += [(f"bs{RESNET_BATCH}", (RESNET_BATCH, hw, hw, c, c), torch.bfloat16, True)
              for hw, c in CONV_SHAPES]
    for idx, (label, shape, dtype, counts) in enumerate(cases):
        name = dtype_name(dtype)
        x, w = conv_inputs(*shape, dtype, 40 + idx)
        got = conv_gemm.conv3x3_gemm_cuda(x, w)
        again = conv_gemm.conv3x3_gemm_cuda(x, w)
        ref = conv_gemm.conv3x3_gemm_plain(x, w)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        top = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        ok = same and bool(torch.isfinite(got).all().item()) and err <= GEMM_TOLERANCE[name] * top
        del got, again, ref
        line = (f"K8 {name} {label} x={shape[:4]} w=(3,3,{shape[3]},{shape[4]}): "
                f"max_abs_err={err:.3e} (tol {GEMM_TOLERANCE[name]:g} x max|y| {top:.3e}), "
                f"bit-equal twice={same}")
        if counts:
            worst_bf16 = max(worst_bf16, err)
            xl, wl = conv_library_inputs(x, w)
            k_ms = median_ms(lambda: conv_gemm.conv3x3_gemm_cuda(x, w))
            p_ms = median_ms(lambda: conv_gemm.conv3x3_gemm_plain(x, w), TIMING_ITERS_SMALL)
            lib_ms = median_ms(lambda: F.conv2d(xl, wl, padding=1))
            nbytes, flops = conv_cost(*shape, 2)
            b_ms, by = bound_ms(nbytes, flops, name)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} conv2d_ms={lib_ms:.4f} "
                     f"bound_ms={b_ms:.4f} ({by})")
            for key, value in zip(("k", "p", "lib", "bytes", "flops"),
                                  (k_ms, p_ms, lib_ms, nbytes, flops)):
                record[key] += value
        print(line, flush=True)
        if not ok:
            failures.append(line)
        del x, w
    if failures:
        fail("K8 disagrees with its plain version: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K8 bf16 bs{RESNET_BATCH} over the four shapes: kernel_ms={record['k']:.4f} "
          f"plain_ms={record['p']:.4f} conv2d_ms={record['lib']:.4f} bound_ms={total_bound:.4f} "
          f"({bound_by}: {record['bytes'] / 1e9:.3f} GB, {record['flops'] / 1e9:.1f} GFLOP)",
          flush=True)
    return {"name": conv_gemm.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/conv3x3_gemm.cu",
            "replaces": "tools/probe_r50_conv_gemm.py:46",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


# K9's shapes: the JAX probe's two (N, H = W, C, mid, rd, k) at batch 256
MBCONV_PROBE = (("probe 56x56 mid144 k3", (56, 24, 144, 6, 3)),
                ("probe 14x14 mid672 k5", (14, 112, 672, 28, 5)))
EFFNET_BATCH = 256
# f32 sums in other orders (f32), or up to two bf16 ulps of the largest |y|
# (one where the two f32 results straddle a rounding boundary, and the
# plain version's depthwise sums round per tap where the kernel fuses)
MBCONV_TOLERANCE = {"float32": 1e-4, "bfloat16": 2.0 ** -6}


def b0_cases(probe, device):
    """B0's nine blocks of K9's form from the port's efficientnet_b0 (random
    weights, randomized BatchNorm statistics): (name, block, folded f32
    parameters, (hw, cin, mid, rd, k))."""
    model = probe.b0_model(device)
    out = []
    for name, block, (hw, _) in probe.b0_blocks(model):
        p = probe.fold_block(block)
        mid = p["w_exp"].shape[1]
        out.append((name, block, p, (hw, p["w_exp"].shape[0], mid, p["w_se1"].shape[1],
                                     p["w_dw"].shape[0])))
    return out


def check_k9(probe, b0):
    """K9 against its plain version at the probe's two shapes and B0's nine
    blocks, f32 at batch 8 and bf16 at batch 256, twice for bit equality,
    each by the route it must take (bf16: the one-launch cluster kernel, f32:
    the three launches); at batch 256 the kernel, the plain version and the
    library chain are timed. The record sums B0's nine blocks; their library
    time is the blocks' own eval forwards (bf16 autocast, channels-last)."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import mbconv_fused as mb
    device = torch.device("cuda", 0)
    failures = []
    worst_bf16 = 0.0
    record = {"k": 0.0, "p": 0.0, "lib": 0.0, "bytes": 0, "flops": 0}
    cases = [(label, shape, None, None) for label, shape in MBCONV_PROBE]
    cases += [(f"b0 {name}", shape, block, p) for name, block, p, shape in b0]
    for idx, (label, (hw, cin, mid, rd, k), block, folded) in enumerate(cases):
        for dtype, n in ((torch.float32, CHECK_BATCH), (torch.bfloat16, EFFNET_BATCH)):
            name = dtype_name(dtype)
            rng = np.random.default_rng(70 + idx)
            x = probe.make_input(rng, n, hw, cin, device, dtype)
            p = folded if folded is not None else probe.make_params(rng, cin, mid, rd, k, device,
                                                                    dtype)
            want = "cluster" if dtype == torch.bfloat16 else "three_launch"
            routes = dict(mb.ROUTE_LAUNCHES)
            got = mb.mbconv_fused_cuda(x, p)
            again = mb.mbconv_fused_cuda(x, p)
            routed = {r: v - routes.get(r, 0) for r, v in mb.ROUTE_LAUNCHES.items()
                      if v != routes.get(r, 0)}
            ref = mb.mbconv_fused_plain(x, p)
            torch.cuda.synchronize()
            same = torch.equal(got, again) and routed == {want: 2}
            top = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            ok = same and bool(torch.isfinite(got).all().item()) \
                and err <= MBCONV_TOLERANCE[name] * top
            del got, again, ref
            line = (f"K9 {name} {label} x=({n},{hw},{hw},{cin}) mid={mid} rd={rd} k={k}: "
                    f"max_abs_err={err:.3e} (tol {MBCONV_TOLERANCE[name]:g} x max|y| {top:.3e}), "
                    f"bit-equal twice and route {want}={same}")
            if n == EFFNET_BATCH:
                worst_bf16 = max(worst_bf16, err)
                k_ms = median_ms(lambda: mb.mbconv_fused_cuda(x, p))
                p_ms = median_ms(lambda: mb.mbconv_fused_plain(x, p), TIMING_ITERS_SMALL)
                if block is None:
                    lw = probe.library_weights(p)
                    with torch.inference_mode():
                        lib_ms = median_ms(lambda: probe.library_block(x, lw))
                    lib_name = "library_chain_ms"
                else:
                    xl = x.permute(0, 3, 1, 2)  # the channels-last NCHW view the model hands it
                    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
                        lib_ms = median_ms(lambda: block(xl))
                    lib_name = "block_eval_forward_ms"
                # x read and y written in bf16, the weights once; the JAX
                # probe's operation count (the two 1x1 products, the taps)
                nbytes = 2 * 2 * n * hw * hw * cin + sum(t.numel() * t.element_size()
                                                         for t in p.values())
                flops = probe.flops(n, hw, cin, mid, k)
                b_ms, by = bound_ms(nbytes, flops, "bfloat16")
                line += (f" route={want} plan={mb.plan_cluster(hw, hw, cin, mid, rd, k)}"
                         f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} {lib_name}={lib_ms:.4f} "
                         f"bound_ms={b_ms:.4f} ({by}: {nbytes / 1e6:.1f} MB, "
                         f"{flops / 1e9:.2f} GFLOP) TFLOP/s={flops / k_ms / 1e9:.2f}")
                if block is not None:
                    for key, value in zip(("k", "p", "lib", "bytes", "flops"),
                                          (k_ms, p_ms, lib_ms, nbytes, flops)):
                        record[key] += value
            print(line, flush=True)
            if not ok:
                failures.append(line)
            del x
    # bf16 where y hangs on the SE mean over the whole image (a strip's own
    # mean, the wrong rank's or the wrong count would show), at B0's shapes
    # whose image a cluster of 2 to 8 blocks holds
    for hw, cin, mid, rd, k in sorted({shape for _, _, _, shape in b0}):
        strips = mb.plan_cluster(hw, hw, cin, mid, rd, k).strips
        if strips == 1:
            continue
        x, p = probe.make_se_case(np.random.default_rng(11), CHECK_BATCH, hw, hw, cin, mid, rd,
                                  k, device, torch.bfloat16)
        routes = dict(mb.ROUTE_LAUNCHES)
        got, again = mb.mbconv_fused_cuda(x, p), mb.mbconv_fused_cuda(x, p)
        ref = mb.mbconv_fused_plain(x, p)
        torch.cuda.synchronize()
        same = torch.equal(got, again) and mb.ROUTE_LAUNCHES["cluster"] == routes.get(
            "cluster", 0) + 2
        top = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        line = (f"K9 bfloat16 SE mean across {strips} strips x=({CHECK_BATCH},{hw},{hw},{cin}) "
                f"mid={mid} k={k}: max_abs_err={err:.3e} (tol {MBCONV_TOLERANCE['bfloat16']:g} "
                f"x max|y| {top:.3e}), bit-equal twice and route cluster={same}")
        print(line, flush=True)
        if not (same and err <= MBCONV_TOLERANCE["bfloat16"] * top):
            failures.append(line)
    if failures:
        fail("K9 disagrees with its plain version or with itself: " + "; ".join(failures))
    total_bound, bound_by = bound_ms(record["bytes"], record["flops"], "bfloat16")
    print(f"K9 bf16 bs{EFFNET_BATCH} over B0's nine blocks: kernel_ms={record['k']:.4f} "
          f"plain_ms={record['p']:.4f} block_eval_forwards_ms={record['lib']:.4f} "
          f"bound_ms={total_bound:.4f} ({bound_by}: {record['bytes'] / 1e9:.3f} GB, "
          f"{record['flops'] / 1e9:.1f} GFLOP)", flush=True)
    return {"name": mb.KERNEL, "route": "cuda",
            "source": "torchok_tpu_torch/csrc/mbconv_fused_fwd.cu",
            "replaces": "tools/probe_mbconv_fused.py:81",
            "launches": 0, "max_abs_err": worst_bf16, "ms": record["k"], "plain_ms": record["p"],
            "bound_ms": total_bound, "bound_by": bound_by, "library_ms": record["lib"]}


def run_mbconv_path(probe, b0, records):
    """The op path of K9: B0's nine blocks at batch 256 in bf16 through
    ``mbconv_fused`` with their folded parameters, each held to the block's
    own eval forward in f32 (2^-7 of its largest output: one bf16 ulp); all
    nine launches by the one-launch cluster route."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import mbconv_fused as mb
    from torchok_tpu_torch.ops.common import LAUNCHES
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(80)
    inputs = [probe.make_input(rng, EFFNET_BATCH, hw, cin, device, torch.bfloat16)
              for _, _, _, (hw, cin, _, _, _) in b0]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    mb.ROUTE_LAUNCHES.clear()
    with torch.inference_mode():
        outs = [mb.mbconv_fused(x, p) for x, (_, _, p, _) in zip(inputs, b0)]
    torch.cuda.synchronize()
    counts = launch_counts()
    routes = {r: v for r, v in mb.ROUTE_LAUNCHES.items() if v}
    for x, y, (name, block, _, (hw, cin, mid, _, k)) in zip(inputs, outs, b0):
        ref = probe.block_reference(block, x)
        top = ref.abs().max().item()
        err = (y.float() - ref).abs().max().item()
        print(f"mbconv_fused {name} ({EFFNET_BATCH},{hw},{hw},{cin}) mid={mid} k={k} bf16 against "
              f"the block's f32 eval forward: max_abs_err={err:.3e} "
              f"(tol {probe.BLOCK_TOLERANCE:g} x {top:.3e})", flush=True)
        if not (err <= probe.BLOCK_TOLERANCE * top and bool(torch.isfinite(y).all().item())):
            fail(f"mbconv_fused differs from B0's {name} eval forward: {err:.3e}")
    require_launches("mbconv_fused op path", counts, {mb.KERNEL: len(b0)})
    print(f"mbconv_fused op path: launches by route {routes}", flush=True)
    if routes != {"cluster": len(b0)}:
        fail(f"mbconv_fused op path: B0's nine blocks must take the cluster route, got {routes}")
    records[mb.KERNEL]["launches"] += counts[mb.KERNEL]


def launch_counts():
    from torchok_tpu_torch.ops.common import LAUNCHES
    return {k: v for k, v in LAUNCHES.items() if v}


def require_launches(label, counts, want):
    """``counts`` must hold exactly the kernel launches in ``want`` and no
    call of a plain version (any other key of the shared counter)."""
    if counts != {k: v for k, v in want.items() if v}:
        fail(f"{label}: expected launches {want} and no plain call, got {counts}")


def load_tool(name):
    """A script of ``tools/`` as a module (``tools`` is not a package)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_op_paths(records):
    """The public ops that reach K6, K7 and K8, at full width: their entry
    points in the JAX package are the ops themselves and two probes."""
    import torch
    import torch.nn.functional as F
    from torchok_tpu_torch.ops import conv_bn, conv_gemm
    from torchok_tpu_torch.ops import window_attention as wa
    from torchok_tpu_torch.ops.common import LAUNCHES

    # K6: window_attention with the kernel on, forward and backward through
    # the hybrid, at swinv2_tiny's stage-1 shape (64 window types per image),
    # against the einsum formulation (its own forward and backward). f32 at
    # batch 8: the kernel does not round the unit vectors and normalises with
    # rsqrt(sum + eps), hence 2e-4 as the JAX package holds it; gradients
    # within 1e-3 of the largest. bf16 at batch 128: within two bf16 ulps of
    # the largest value (the einsum formulation rounds qn, kn and the weights).
    hp, wp, c, heads = STAGES[0]
    nw = (hp // 8) * (wp // 8)
    LAUNCHES.clear()
    wa.FWD_ROUTE_LAUNCHES.clear()
    for dtype, batch, out_tol, grad_tol in ((torch.float32, CHECK_BATCH, 2e-4, 1e-3),
                                            (torch.bfloat16, 128, 4e-2, 4e-2)):
        q, k, v, logit_scale, bias, mask = mw_inputs(batch * nw, heads, nw, dtype, 50)
        g = torch.Generator(device="cuda")
        g.manual_seed(51)
        dout = torch.randn(q.shape, generator=g, device=q.device).to(dtype)
        results = []
        for use_kernel in (True, False):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v, logit_scale, bias)]
            out = wa.window_attention(*leaves, mask, use_kernel)
            grads = torch.autograd.grad(out, leaves, dout)
            results.append((out.detach(), grads))
        torch.cuda.synchronize()
        (out_k, grads_k), (out_e, grads_e) = results
        err = (out_k.float() - out_e.float()).abs().max().item()
        parts = [f"out err={err:.3e} (tol {out_tol:g})"]
        ok = err <= out_tol and bool(torch.isfinite(out_k).all().item())
        for key, a, b in zip(("dq", "dk", "dv", "dlogit_scale", "dbias"), grads_k, grads_e):
            gerr = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            ok = ok and gerr <= grad_tol * top
            parts.append(f"{key} err={gerr:.3e} (tol {grad_tol:g} x {top:.3e})")
        print(f"window_attention use_kernel {dtype_name(dtype)} q=({batch * nw},{heads},64,32) "
              f"compact mask of {nw}: " + ", ".join(parts), flush=True)
        if not ok:
            fail("window_attention through the kernel differs from the einsum formulation")
        del results, out_k, out_e, grads_k, grads_e, q, k, v, dout
    counts = launch_counts()
    require_launches("window_attention op path", counts, {wa.KERNEL: 2})
    if dict(wa.FWD_ROUTE_LAUNCHES) != {"fma": 1, "mma": 1}:
        fail("window_attention op path: expected the f32 launch on the FMA route and the bf16 "
             f"one on the tensor cores, got {dict(wa.FWD_ROUTE_LAUNCHES)}")
    records[wa.KERNEL]["launches"] += counts[wa.KERNEL]

    # K7: the probe's bottleneck chain, fused against unfused, forward and
    # backward. Both chains round y to bf16 from f32 sums in different orders,
    # and the unfused backward rounds each layer's input gradient to bf16
    # where the fused one keeps f32: differences of a few bf16 ulps per layer
    # over eight layers, hence 5e-2 of the largest gradient; the loss is a
    # mean over 50,176 rows, held to 1e-2 relative.
    probe = load_tool("probe_torch_conv_bn")
    m, wide, narrow = probe.STAGES[CHAIN_STAGE]
    device = torch.device("cuda", 0)
    params = probe.make_params(0, wide, narrow, CHAIN_LAYERS, device)
    x = probe.make_input(1, m, wide, device, torch.bfloat16)
    LAUNCHES.clear()
    conv_bn.ROUTE_LAUNCHES.clear()
    result = probe.parity(params, x)
    torch.cuda.synchronize()
    counts = launch_counts()
    if dict(conv_bn.ROUTE_LAUNCHES) != {"wgmma": CHAIN_LAYERS}:
        fail(f"conv_bn chain: expected {CHAIN_LAYERS} launches on the wgmma route, got "
             f"{dict(conv_bn.ROUTE_LAUNCHES)}")
    print(f"conv_bn chain stage {CHAIN_STAGE} M={m} {wide}<->{narrow} x{CHAIN_LAYERS} bf16: "
          f"loss unfused={result['loss_unfused']:.6f} fused={result['loss_fused']:.6f}; "
          "max grad err / max |grad|: "
          + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in result["grad_rel_err"].items())
          + f"; launches {counts}", flush=True)
    require_launches("conv_bn chain", counts, {conv_bn.KERNEL: CHAIN_LAYERS})
    records[conv_bn.KERNEL]["launches"] += counts[conv_bn.KERNEL]
    losses = (result["loss_unfused"], result["loss_fused"])
    if not all(math.isfinite(v_) for v_ in losses) \
            or abs(losses[0] - losses[1]) > 1e-2 * max(abs(losses[0]), 1e-3):
        fail(f"conv_bn chain: fused and unfused losses differ: {losses}")
    if not all(v_ <= 5e-2 for v_ in result["grad_rel_err"].values()):
        fail(f"conv_bn chain: fused and unfused gradients differ: {result['grad_rel_err']}")
    sps_u = probe.steps_per_second(probe.loss_unfused, params, x, 5)
    sps_f = probe.steps_per_second(probe.loss_fused, params, x, 5)
    print(f"conv_bn chain fwd+bwd (a smoke reading, host clock around 5 steps): unfused "
          f"{1e3 / sps_u:.3f} ms/step, fused {1e3 / sps_f:.3f} ms/step", flush=True)
    del params, x

    # K8: the op over the probe's four shapes against F.conv2d (cuDNN picks
    # its own algorithm and summation order: 2e-2 of the largest output)
    LAUNCHES.clear()
    for idx, (hw, ch) in enumerate(CONV_SHAPES):
        x, w = conv_inputs(RESNET_BATCH, hw, hw, ch, ch, torch.bfloat16, 60 + idx)
        got = conv_gemm.conv3x3_gemm(x, w).float()
        xl, wl = conv_library_inputs(x, w)
        ref = F.conv2d(xl, wl, padding=1).permute(0, 2, 3, 1).float()
        torch.cuda.synchronize()
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        print(f"conv3x3_gemm ({RESNET_BATCH},{hw},{hw},{ch}) against F.conv2d: max rel diff "
              f"{rel:.3e} (tol 2e-2)", flush=True)
        if not rel <= 2e-2:
            fail(f"conv3x3_gemm differs from F.conv2d at {hw}x{hw}x{ch}: {rel:.3e}")
        del x, w, got, ref, xl, wl
    counts = launch_counts()
    require_launches("conv3x3_gemm op path", counts, {conv_gemm.KERNEL: len(CONV_SHAPES)})
    records[conv_gemm.KERNEL]["launches"] += counts[conv_gemm.KERNEL]


def unzero_last_norms(model, images):
    """Give every zero-initialised last norm of a ResNet block unit scale, so
    the f32 reference exercises the convs inside the blocks (at the initial
    zero each block is the identity)."""
    import torch
    with torch.no_grad():
        for module in model.modules():
            if getattr(module, "zero_init", False):
                module.weight.fill_(1.0)


def calibrate_norms(model, images):
    """Give every BatchNorm the statistics of the reference images. At the
    initial law the eval-mode activations of EfficientNet-B0 and MobileNetV3
    fade through the blocks (their logits are of order 1e-14 and 1e-9), so
    the f32 reference would compare zeros; other images' statistics leave
    logits in the hundreds, where f32 rounding nears the 1e-3 limit."""
    import torch
    from torchok_tpu_torch.models.modules.bricks.batchnorm import BatchNorm2d
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    kept = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 0.0  # Flax's momentum, the share kept: the batch's statistics
    model.train()
    with torch.no_grad():
        model({"image": images})
    model.eval()
    for m, momentum in zip(norms, kept):
        m.momentum = momentum


def require_fwd_routes(label, per_forward, forwards):
    """The plain-dot forwards' launches by (kernel, route) since the counter
    was cleared (``ops.window_attention_dot.FWD_ROUTE_LAUNCHES``) must be
    ``forwards`` times ``per_forward``; None checks nothing."""
    from torchok_tpu_torch.ops import window_attention_dot as dot
    if per_forward is None:
        return
    routes = {k: v for k, v in dot.FWD_ROUTE_LAUNCHES.items() if v}
    want = {k: n * forwards for k, n in per_forward.items() if n}
    print(f"{label} K3a/K4 launches by route: {routes}", flush=True)
    if routes != want:
        fail(f"{label}: expected K3a/K4 launches by route {want}, got {routes}")


def run_slice(label, config, per_forward, records, image_size, prepare_reference=None,
              fwd_routes=None):
    """The inference slice of one model: ``per_forward`` maps each kernel to
    its launches per forward; ``records`` maps it to its JSON record.
    ``prepare_reference(model, images)`` may change the model before the f32
    reference run on ``images``. ``fwd_routes``, if given, maps each (K3a or
    K4 kernel, route) to its launches per forward."""
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES

    # warm-up run (cuDNN/cuBLAS plans, allocator) outside the measured one
    warm = copy.deepcopy(config)
    warm["trainer"]["limit_test_batches"] = 1
    run(warm, "test")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, logs = run(copy.deepcopy(config), "test")
    torch.cuda.synchronize()
    test_counts = launch_counts()
    require_fwd_routes(f"{label} test", fwd_routes, BATCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_eval
    batch_size = config["data"]["TEST"][0]["dataloader"]["batch_size"]
    print(f"{label} test: {stats['images']} images in {stats['seconds']:.4f} s = "
          f"{stats['images'] / stats['seconds']:.2f} img/s (bs{batch_size} bf16, {BATCHES} "
          f"batches, host clock incl. loading); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {test_counts}; logs {logs}", flush=True)

    LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, preds = run(copy.deepcopy(config), "predict")
    torch.cuda.synchronize()
    predict_counts = launch_counts()
    require_fwd_routes(f"{label} predict", fwd_routes, BATCHES)
    print(f"{label} predict: {len(preds)} batches; launches {predict_counts}", flush=True)

    want = {k: n * BATCHES for k, n in per_forward.items()}
    require_launches(f"{label} test", test_counts, want)
    require_launches(f"{label} predict", predict_counts, want)
    for key in ("test/Accuracy", "test/F1Score"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{label}: {key} missing or not finite in {logs}")
    if len(preds) != BATCHES:
        fail(f"{label}: predict returned {len(preds)} batches, expected {BATCHES}")
    for p in preds:
        logits = p["prediction"]
        if logits.shape != (batch_size, 1000) or not np.isfinite(logits).all():
            fail(f"{label}: bad logits: shape {logits.shape}, "
                 f"finite {bool(np.isfinite(logits).all())}")

    # reference on a small input: the same weights in f32, kernels on the
    # card against the plain attention on the CPU
    model = trainer.state.model.float()
    image = torch.from_numpy(trainer.task.predict_dataloader()[0].dataset.images[:2])
    if tuple(image.shape[1:3]) != (image_size, image_size):
        fail(f"{label}: images are {tuple(image.shape)}, expected {image_size} px")
    image = (image.float() / 255.0 - 0.45) / 0.225
    batch = {"image": image.permute(0, 3, 1, 2).contiguous()}
    if prepare_reference is not None:
        prepare_reference(model, batch["image"].cuda())
    with torch.inference_mode():
        on_card = model({"image": batch["image"].cuda()})["prediction"].cpu()
        on_cpu = model.cpu()({"image": batch["image"]})["prediction"]
    err = (on_card - on_cpu).abs().max().item()
    # other summation orders through every layer, f32 on both sides (TF32 off
    # for matmul and cuDNN)
    print(f"{label} reference (f32, 2 images, card vs CPU): max_abs_err={err:.3e} "
          f"(tol 1e-3), logit scale {on_cpu.abs().max().item():.3e}", flush=True)
    if not err <= 1e-3:
        fail(f"{label}: model logits on the card differ from the CPU run by {err:.3e}")
    for kernel, count in test_counts.items():
        records[kernel]["launches"] += count


def smoke_train_config(epochs: int, config=None, size: int = 256, batch: int = 128):
    """A train recipe (``TRAIN_CONFIG`` by default) with the train set cut to
    one batch, repeated for ``epochs`` one-step epochs (so each epoch's
    ``train/loss`` is one step's loss), one sanity validation batch and one
    validation batch at the end."""
    cfg = copy.deepcopy(TRAIN_CONFIG if config is None else config)
    cfg["data"]["TRAIN"] = _synthetic(batch, False, True, size, batch)
    cfg["data"]["VALID"] = _synthetic(batch, False, False, size, batch, seed=1)
    cfg["trainer"].update(max_epochs=epochs, check_val_every_n_epoch=epochs)
    return cfg


def run_train_slice(label, config, size, per_forward, per_backward, must_move, records,
                    per_route=None, fwd_routes=None):
    """The train slice of one model: ``per_forward`` / ``per_backward`` map
    each kernel to its launches per forward / per train step; ``must_move``
    lists name fragments of parameters that have to change (None: every
    parameter); ``per_route``,
    if given, maps each (K3b or K5 kernel, route) to its launches per train
    step (``ops.window_attention_dot.ROUTE_LAUNCHES``), ``fwd_routes`` each
    (K3a or K4 kernel, route) to its launches per forward."""
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def __init__(self):
            self.epochs = []
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

        def on_epoch_end(self, trainer, task, logs):
            self.epochs.append(dict(logs))

    batch = config["data"]["TRAIN"][0]["dataloader"]["batch_size"]
    # warm-up run (cuBLAS plans, allocator, optimizer kernels) outside the measured one
    run(smoke_train_config(2, config, size, batch), "train")
    torch.cuda.synchronize()

    recorder = Recorder()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    dot.ROUTE_LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, logs = run(smoke_train_config(TRAIN_STEPS, config, size, batch), "train",
                        [recorder])
    torch.cuda.synchronize()
    counts = launch_counts()
    routes = {k: v for k, v in dot.ROUTE_LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_fit
    losses = [e["train/loss"] for e in recorder.epochs]
    print(f"{label} train: {stats['steps']} steps, {stats['images']} images in "
          f"{stats['seconds']:.4f} s = {stats['images'] / stats['seconds']:.2f} img/s "
          f"(bs{batch} bf16, a smoke reading: host clock, first fetch to each step's loss "
          f"read-back, one step per epoch); peak device memory {peak / 2**20:.1f} MiB; "
          f"launches {counts}", flush=True)
    print(f"{label} train losses per step: " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    if per_route is not None:
        print(f"{label} train K3b/K5 launches by route: {routes}", flush=True)
        if routes != {k: n * TRAIN_STEPS for k, n in per_route.items() if n}:
            fail(f"{label} train: expected K3b/K5 launches by route "
                 f"{ {k: n * TRAIN_STEPS for k, n in per_route.items()} }, got {routes}")
    print(f"{label} last epoch logs: {logs}", flush=True)

    eval_batches = 2  # one sanity batch, one validation batch after the last epoch
    require_fwd_routes(f"{label} train", fwd_routes, TRAIN_STEPS + eval_batches)
    want = {k: n * (TRAIN_STEPS + eval_batches) for k, n in per_forward.items()}
    want.update({k: n * TRAIN_STEPS for k, n in per_backward.items()})
    require_launches(f"{label} train", counts, want)
    if stats["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        fail(f"{label} train: expected {TRAIN_STEPS} steps, got {stats['steps']} "
             f"({len(losses)} logged)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label} train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label} train: the loss did not fall on the repeated batch: {losses}")
    for key in ("valid/Accuracy", "valid/loss"):
        if key not in logs or not math.isfinite(logs[key]):
            fail(f"{label}: {key} missing or not finite in {logs}")
    if must_move is None:
        must_move = [name for name, _ in trainer.state.model.named_parameters()]
    moved = dict.fromkeys(must_move, False)
    for name, value in trainer.state.model.state_dict().items():
        if not bool(torch.isfinite(value).all().item()):
            fail(f"{label} train: parameter {name} is not finite")
        for key in moved:
            if key in name and not torch.equal(value, recorder.initial[name]):
                moved[key] = True
    if not all(moved.values()):
        fail(f"{label} train: parameters that never changed: "
             f"{[k for k, v in moved.items() if not v]}")
    for kernel, count in counts.items():
        records[kernel]["launches"] += count


def gradient_reference(label, config, size, want, probe, drop_path=True, dtype="float32"):
    """One forward + backward of the full-width model on two images in
    ``dtype``: the card (the kernels in ``want``, with their launch counts)
    against the CPU (plain versions), all parameter gradients. ``probe``
    names a parameter that must be among them. ``drop_path``: the backbone
    takes a stochastic depth rate, set to 0 here. A model that reaches no
    hand-written kernel may take f64 (HRNet-W18: f32 weight gradients lie
    more than 1e-3 of the largest from f64 on the card and on its host's
    CPU); the distance of each side's f32 gradients from the reference is
    printed then."""
    import torch
    import torchok_tpu_torch  # noqa: F401 — registers the components
    from torchok_tpu_torch.constructor import TASKS
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import merge_structured
    from torchok_tpu_torch.ops.common import LAUNCHES

    cfg = copy.deepcopy(config)
    if drop_path:
        cfg["task"]["params"]["backbone_params"]["drop_path_rate"] = 0.0
    config = merge_structured(config_from_dict(cfg))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    generator = torch.Generator()
    generator.manual_seed(5)
    task.init_weights(generator)
    image = torch.randn((2, 3, size, size), generator=generator)
    target = torch.tensor([3, 977])

    def grads(device, dtype=dtype):
        model = task.model.to(device=device, dtype=getattr(torch, dtype)).train()
        model.zero_grad(set_to_none=True)
        out = model({"image": image.to(device=device, dtype=getattr(torch, dtype)),
                     "target": target.to(device)})
        total, _ = task.compute_loss(out)
        total.backward()
        # parameters outside the classification path (SwinV2's three inner
        # feature norms) get no gradient
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                if p.grad is not None}, total.item()

    LAUNCHES.clear()
    on_card, loss_card = grads(torch.device("cuda", 0))
    torch.cuda.synchronize()
    counts = launch_counts()
    on_cpu, loss_cpu = grads(torch.device("cpu"))
    if set(on_card) != set(on_cpu) or not any(probe in n for n in on_cpu):
        fail(f"{label} gradient reference: the card and the CPU gave gradients to "
             "different parameters")
    worst_name, worst, largest = "", 0.0, 0.0
    for name, ref in on_cpu.items():
        err = (on_card[name] - ref).abs().max().item()
        largest = max(largest, ref.abs().max().item())
        if err > worst:
            worst_name, worst = name, err
    tol = 1e-3 * largest  # one dtype on both sides, other summation orders through every block
    print(f"{label} gradient reference ({dtype}, 2 images, card kernels vs CPU plain): loss "
          f"{loss_card:.6f} vs {loss_cpu:.6f}; max_abs_err={worst:.3e} at {worst_name} "
          f"(tol 1e-3 x largest gradient {largest:.3e} = {tol:.3e}); launches {counts}",
          flush=True)
    require_launches(f"{label} gradient reference (card)", counts, want)
    if not worst <= tol:
        fail(f"{label}: gradients on the card differ from the CPU run by {worst:.3e} "
             f"at {worst_name}")
    if dtype != "float32":
        # how far f32 gradients lie from this reference on each side (no gate)
        for device in (torch.device("cuda", 0), torch.device("cpu")):
            got = grads(device, "float32")[0]
            off = max(((got[n].to(ref.dtype) - ref).abs().max().item(), n)
                      for n, ref in on_cpu.items())
            print(f"{label}: f32 gradients on {device.type} lie {off[0]:.3e} "
                  f"({off[0] / largest:.3e} of the largest) from the CPU's {dtype} ones, at "
                  f"{off[1]}", flush=True)


def sass_functions(kernel, library=None) -> dict:
    """The SASS of each function in the built library of ``kernel`` (or in
    the library at the path ``library``), by name."""
    import shutil
    from torchok_tpu_torch.utils.cuda_build import library_path
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library or library_path(kernel))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    return {part.split("\n", 1)[0].strip(): part for part in sass.split("Function : ")[1:]}


def sass_has_hgmma(kernel) -> bool:
    """Whether the built library of ``kernel`` holds HGMMA (wgmma) in its SASS."""
    return any("HGMMA" in text for text in sass_functions(kernel).values())


def ptxas_usage(kernel, needle):
    """(function, registers, spill stores, spill loads) of each entry function
    of ``kernel``'s build whose mangled name matches the regular expression
    ``needle``, from the compiler's ``-Xptxas -v`` output."""
    from torchok_tpu_torch.utils.cuda_build import build_log
    found, name, spills = [], None, (0, 0)
    for ln in build_log(kernel).splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "bytes spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spills = (nums[1], nums[2])  # stack frame, spill stores, spill loads
        elif "Used" in ln and "registers" in ln and name and re.search(needle, name):
            regs = int(ln.split("Used")[1].split()[0])
            found.append((name, regs) + spills)
            name = None
    return found


def check_hmma(kind, library, needle, count=4):
    """The ``count`` tensor-core kernels of ``library``'s build whose mangled
    names match the regular expression ``needle``: registers and spills, and
    HMMA in their SASS."""
    usage = ptxas_usage(library, needle)
    for name, regs, stores, loads in usage:
        print(f"{kind} mma {name}: {regs} registers, spill stores {stores} B, "
              f"spill loads {loads} B", flush=True)
    sass = {n: t for n, t in sass_functions(library).items() if re.search(needle, n)}
    with_hmma = sorted(n for n, t in sass.items() if "HMMA" in t)
    print(f"{kind} SASS has HMMA in {len(with_hmma)} of its {len(sass)} tensor-core kernels",
          flush=True)
    if len(usage) != count or len(sass) != count or len(with_hmma) != count:
        fail(f"{kind}'s tensor-core kernels: {len(usage)} in the build log, {len(sass)} in the "
             f"SASS, {len(with_hmma)} with HMMA (expected {count} each)")


def check_mma_build(kind, library, needle, route, count=4, windows=None):
    """The bf16 tensor-core kernels of K1 to K5 (``check_hmma``) and the
    route each window size (by default those of ``SWIN_MODELS``) takes per
    dtype (``route``: bf16 on the tensor-core kernel, f32 on the FMA
    templates or the key-tiled path)."""
    import torch
    check_hmma(kind, library, needle, count)
    if windows is None:
        windows = sorted({st[4] for _, stages in SWIN_MODELS.values() for st in stages})
    for ws in windows:
        routes = {dtype_name(t): route(t, ws) for t in (torch.bfloat16, torch.float32)}
        print(f"{kind} route L={ws * ws} (ws {ws}): bf16 {routes['bfloat16']}, "
              f"f32 {routes['float32']}", flush=True)
        if routes["bfloat16"] != "mma" or routes["float32"] == "mma":
            fail(f"{kind} at ws {ws}: bf16 must take the tensor-core kernel and f32 the FMA "
                 f"kernels, got {routes}")


def run_swinv2_variants(records):
    """Every registered SwinV2 variant at its own input size, batch 1, bf16
    autocast, random weights from a seed: one K1 launch per block (windows 6
    to 24, L 36 to 576), no plain call, finite features."""
    import torch
    from torchok_tpu_torch.constructor import BACKBONES
    from torchok_tpu_torch.models.backbones.swin import _VARIANTS
    from torchok_tpu_torch.ops import swin_attention as swin
    from torchok_tpu_torch.ops.common import LAUNCHES
    device = torch.device("cuda", 0)
    for name, cfg in sorted(_VARIANTS.items()):
        size = cfg.get("img_size", 256)
        grid = [size // 4 // 2 ** i for i in range(len(cfg["depths"]))]
        windows = [min(g_, cfg["window_size"]) ** 2 for g_ in grid]
        torch.manual_seed(0)
        model = BACKBONES.get(name)().to(device).eval()
        image = torch.randn((1, 3, size, size), device=device)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            feat = model(image)
        torch.cuda.synchronize()
        counts = launch_counts()
        finite = bool(torch.isfinite(feat).all().item())
        print(f"{name} ({size}x{size}, bs1, bf16): L per stage {windows}, features "
              f"{tuple(feat.shape)}, finite {finite}; launches {counts}", flush=True)
        require_launches(f"{name} forward", counts, {swin.KERNEL: sum(cfg["depths"])})
        if not finite:
            fail(f"{name}: features are not finite")
        records[swin.KERNEL]["launches"] += counts[swin.KERNEL]
        del model, image, feat


def run_shapes_recipe():
    """``configs/classification_shapes.yaml`` at its short budget through
    ``run(..., "train")`` as a user runs it (``steps_per_execution`` 16, bf16
    autocast, 8 loader workers, CSVLogger, ModelCheckpoint, FinalizeLogger):
    the reference's accuracy, step count and CSV rows, the status, one best
    checkpoint and ``last.ckpt``, then ``+mode=test`` from the best
    checkpoint reproducing its epoch's accuracy. ResNet-18 reaches no
    hand-written kernel (nor does the JAX one a Pallas kernel). Returns the
    best checkpoint's ``state_dict``."""
    import csv
    import glob
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="shapes_") as tmp:
        LAUNCHES.clear()
        trainer, logs = run(shapes_config(os.path.join(tmp, "train")), "train")
        torch.cuda.synchronize()
        require_launches("shapes recipe train", launch_counts(), {})
        stats = trainer.last_fit
        accuracy = logs.get("valid/Accuracy", float("nan"))
        floor = SHAPES_REFERENCE - SHAPES_TOLERANCE
        print(f"shapes recipe (resnet18, short budget): valid/Accuracy={accuracy:.4f} at "
              f"global_step {trainer.global_step} (the reference's short budget 0.7573, "
              f"floor {floor:.4f}); valid/F1Score={logs.get('valid/F1Score', float('nan')):.4f}; "
              f"smoke train img/s {stats['images'] / stats['seconds']:.2f} (a smoke reading: "
              f"host clock, first fetch to each epoch's loss read-back, {stats['steps']} steps, "
              f"{stats['images']} images in {stats['seconds']:.3f} s, bs128 x 16 per execution, "
              f"bf16) on {card_line()}", flush=True)
        if not accuracy >= floor:
            fail(f"shapes recipe: valid/Accuracy {accuracy:.4f} below {floor:.4f}")
        if trainer.global_step != SHAPES_STEPS or stats["steps"] != SHAPES_STEPS:
            fail(f"shapes recipe: {trainer.global_step} steps ({stats['steps']} run), "
                 f"expected {SHAPES_STEPS}")
        log_dir = trainer.logger.log_dir
        with open(os.path.join(log_dir, "metrics.csv"), newline="") as f:
            rows = list(csv.reader(f))
        steps = [int(r[0]) for r in rows[1:]]
        train_rows = [r for r in rows[1:] if all(v == "" for v in r[2:])]
        print(f"shapes recipe metrics.csv: header {rows[0]}, steps {steps}, "
              f"{len(train_rows)} train-loss rows", flush=True)
        if rows[0] != SHAPES_CSV_HEADER or steps != SHAPES_CSV_STEPS or len(train_rows) != 5:
            fail(f"shapes recipe: metrics.csv rows {rows[0]} at steps {steps}, expected "
                 f"{SHAPES_CSV_HEADER} at {SHAPES_CSV_STEPS} with 5 train-loss rows")
        with open(os.path.join(log_dir, "status.txt")) as f:
            status = f.read()
        if status != "success":
            fail(f"shapes recipe: status.txt reads {status!r}")
        saver = next(cb for cb in trainer.callbacks if isinstance(cb, ModelCheckpoint))
        kept = sorted(os.path.basename(p) for p in glob.glob(os.path.join(saver.dirpath, "*")))
        best = [k for k in kept if re.fullmatch(r"epoch=\d+-step=\d+\.ckpt", k)]
        print(f"shapes recipe checkpoints: {kept}; best {os.path.basename(saver.best_model_path)}"
              f" (valid/F1Score {saver.best_model_score:.4f})", flush=True)
        if len(best) != 1 or sorted(kept) != sorted(best + ["last.ckpt"]):
            fail(f"shapes recipe: expected one epoch=*-step=*.ckpt and last.ckpt, got {kept}")
        saved = torch.load(saver.best_model_path, map_location="cpu", weights_only=True)
        logged = saved["metrics"]["valid/Accuracy"]

        test_cfg = shapes_config(os.path.join(tmp, "test"))
        test_cfg["data"]["TEST"] = test_cfg["data"]["VALID"]
        test_cfg["resume_path"] = saver.best_model_path
        LAUNCHES.clear()
        _, test_logs = run(test_cfg, "test")
        torch.cuda.synchronize()
        require_launches("shapes recipe test", launch_counts(), {})
        tested = test_logs.get("test/Accuracy", float("nan"))
        print(f"shapes recipe +mode=test from the best checkpoint (epoch {saved['epoch']}): "
              f"test/Accuracy={tested:.6f} against its logged valid/Accuracy={logged:.6f} "
              f"(tol 1e-3)", flush=True)
        if not abs(tested - logged) <= 1e-3:
            fail(f"shapes recipe: +mode=test gives {tested:.6f}, the checkpoint's epoch logged "
                 f"{logged:.6f}")
    print(f"shapes recipe phase: {time.perf_counter() - start:.1f} s", flush=True)
    return saved["state_dict"]


def recall_bounds(targets, k):
    """(lower factor, upper bound) of the recipe's RecallAtKMeter on a
    gallery with these class labels: a query of a class of n finds at most
    min(k, n - 1) of its n - 1 relevant items, and at least one where its
    first neighbour is relevant, so recall@k >= hit@1 x the lower factor."""
    import numpy as np
    sizes = np.bincount(targets)[targets] - 1
    upper = float(np.mean(np.minimum(k, sizes) / sizes))
    return 1.0 / sizes.max(), upper


def witness_recall(state, k, batch=512):
    """RecallAtKMeter's value recomputed from the state its last ``compute``
    was given: the epoch's embeddings normalised by row, ``FlatIndex`` on
    their device in the meter's query batches, k + 1 neighbours with the
    first (the query itself) dropped, and found / relevant counted in numpy
    (relevant: the query's class less the query)."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import knn

    vectors = torch.cat(state["vectors"]).float()
    unit = vectors / torch.clamp_min(torch.linalg.vector_norm(vectors, dim=1, keepdim=True),
                                     1e-12)
    labels = np.concatenate([np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t)
                             for t in state["group_labels"]])
    index = knn.FlatIndex(unit, "IP")
    found = []
    for start in range(0, len(unit), batch):
        rows = np.arange(start, min(start + batch, len(unit)))
        _, idxs = index.search(unit[start:start + len(rows)], k + 1)
        neighbours = idxs[:, 1:]
        relevant = (labels[neighbours] == labels[rows][:, None]) & (neighbours != rows[:, None])
        found.append(relevant.sum(1))
    sizes = np.bincount(labels)[labels] - 1
    return float(np.mean(np.concatenate(found) / sizes))


def run_arcface_recipe():
    """``configs/representation_arcface_shapes.yaml`` at its short budget
    through ``run(..., "train")`` as a user runs it (resnet18 at 32x32,
    PoolingLinear to 128, ArcFaceHead, f32, ``steps_per_execution`` 16, 4
    loader workers, CSVLogger, FinalizeLogger): the reference's recall@1,
    recall@5 within the range its semantics allow and equal to its numpy
    witness (``witness_recall``), the step count, the CSV
    columns of the meters' tags, every kNN search on the card and none on the
    host. ResNet-18 reaches no hand-written kernel (nor does the JAX one a
    Pallas kernel), and ``ops/knn.py`` has none to reach."""
    import csv
    import math as math_
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor import DATASETS, METRICS
    from torchok_tpu_torch.ops import knn
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    # the state of RecallAtKMeter's last compute, the last epoch's
    recall_meter = METRICS.get("RecallAtKMeter")
    compute, kept = recall_meter.compute, {}

    def keep_state(meter, state):
        kept["state"] = state
        return compute(meter, state)

    with tempfile.TemporaryDirectory(prefix="arcface_") as tmp:
        LAUNCHES.clear()
        knn.SEARCHES.clear()
        recall_meter.compute = keep_state
        try:
            trainer, logs = run(arcface_config(os.path.join(tmp, "train")), "train")
        finally:
            del recall_meter.compute
        torch.cuda.synchronize()
        require_launches("arcface recipe train", launch_counts(), {})
        searches = dict(knn.SEARCHES)
        stats = trainer.last_fit
        recall1 = logs.get("valid/recall_at_1", float("nan"))
        recall5 = logs.get("valid/recall_at_5", float("nan"))
        floor = ARCFACE_REFERENCE - ARCFACE_TOLERANCE
        valid = ARCFACE_RECIPE["data"]["VALID"][0]["dataset"]["params"]
        targets = DATASETS.get("SyntheticShapesDataset")(None, **valid).targets
        per_hit, upper = recall_bounds(targets, 5)
        lower = recall1 * per_hit
        print(f"arcface recipe (resnet18 + PoolingLinear 128 + ArcFaceHead, short budget): "
              f"valid/recall_at_1={recall1:.4f} at global_step {trainer.global_step} (the "
              f"reference's short budget 0.7255, floor {floor:.4f}); valid/recall_at_5="
              f"{recall5:.6f} (RecallAtKMeter: found / relevant, so within [{lower:.6f}, "
              f"{upper:.6f}] for these 2000 labels); kNN searches per device {searches}; "
              f"smoke train img/s {stats['images'] / stats['seconds']:.2f} (a smoke reading: "
              f"host clock, first fetch to each epoch's loss read-back, {stats['steps']} steps, "
              f"{stats['images']} images in {stats['seconds']:.3f} s, bs128 x 16 per execution, "
              f"f32) on {card_line()}", flush=True)
        if not recall1 >= floor:
            fail(f"arcface recipe: valid/recall_at_1 {recall1:.4f} below {floor:.4f}")
        if not (math_.isfinite(recall5) and lower <= recall5 <= upper):
            fail(f"arcface recipe: valid/recall_at_5 {recall5} outside [{lower}, {upper}]")
        if trainer.global_step != ARCFACE_STEPS or stats["steps"] != ARCFACE_STEPS:
            fail(f"arcface recipe: {trainer.global_step} steps ({stats['steps']} run), "
                 f"expected {ARCFACE_STEPS}")
        # two meters, one search batch of 512 queries at a time, per epoch
        want_searches = {"cuda": 2 * 4 * 8}
        if searches != want_searches:
            fail(f"arcface recipe: kNN searches per device {searches}, expected {want_searches}")
        witness = witness_recall(kept["state"], 5)
        print(f"arcface recipe: valid/recall_at_5 recomputed in numpy from the last epoch's "
              f"{len(targets)} embeddings (FlatIndex on the card, k 6, the query's own row "
              f"dropped) {witness:.12f} against the meter's {recall5:.12f} (tol 1e-9)",
              flush=True)
        if not abs(witness - recall5) <= 1e-9:
            fail(f"arcface recipe: valid/recall_at_5 {recall5} differs from its numpy "
                 f"witness {witness}")
        with open(os.path.join(trainer.logger.log_dir, "metrics.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        epochs = [r for r in rows if r["valid/recall_at_1"]]
        print(f"arcface recipe metrics.csv: columns {list(rows[0])}; valid/recall_at_1 by epoch "
              f"{[round(float(r['valid/recall_at_1']), 4) for r in epochs]}", flush=True)
        if list(rows[0]) != ARCFACE_CSV_HEADER or len(epochs) != 8 or \
                any(not r["valid/recall_at_5"] for r in epochs):
            fail(f"arcface recipe: metrics.csv columns {list(rows[0])} with {len(epochs)} epoch "
                 f"rows, expected {ARCFACE_CSV_HEADER} with 8")
        with open(os.path.join(trainer.logger.log_dir, "status.txt")) as f:
            status = f.read()
        if status != "success":
            fail(f"arcface recipe: status.txt reads {status!r}")
    print(f"arcface recipe phase: {time.perf_counter() - start:.1f} s", flush=True)


def timed_search(index, queries, k, repeats=5):
    """Median wall milliseconds of ``index.search`` (which returns host arrays,
    so each call waits for the card)."""
    import torch
    index.search(queries, k)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.search(queries, k)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _clustered(rng, n_clusters, per_cluster, d, spread):
    import numpy as np
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = np.repeat(centers, per_cluster, axis=0)
    return (pts + rng.normal(scale=spread, size=pts.shape)).astype(np.float32)


KNN_GALLERY = (2000, 128)           # the arcface recipe's valid gallery
IVF_GALLERY = (1000, 200, 128)      # clusters, rows each, width: 200k rows, 102 MB in f32
KNN_K = 6                           # RecallAtKMeter's k + 1


def check_knn_index():
    """``ops/knn.py`` on the card: ``FlatIndex`` against the same search in
    f64 numpy on the host (identical indexes on unit vectors whose f64
    neighbours are at least 1e-5 apart, scores within 1e-4; duplicated
    integer vectors, whose products are exact, tie to the lower index), and
    ``IvfIndex`` on a 200k x 128 clustered gallery against the exact index
    (recall@1 >= 0.9, as ``tests/test_retrieval_metrics.py`` holds it on the
    CPU), with the search times."""
    import numpy as np
    import torch
    from torchok_tpu_torch.ops import knn

    start = time.perf_counter()
    knn.SEARCHES.clear()
    device = torch.device("cuda", 0)
    # seed 19: the f64 neighbours of these queries are at least 2.4e-5 apart
    rng = np.random.default_rng(19)
    n, d = KNN_GALLERY
    gallery = rng.normal(size=(n, d))
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    gallery = gallery.astype(np.float32)
    queries = gallery[:512] + 0.05 * rng.normal(size=(512, d)).astype(np.float32)
    g64, q64 = gallery.astype(np.float64), queries.astype(np.float64)
    ip = q64 @ g64.T
    l2 = (q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :] - 2 * ip
    for metric, key in (("IP", -ip), ("L2", l2)):
        order = np.argsort(key, axis=1, kind="stable")[:, :KNN_K]
        ranked = np.take_along_axis(key, np.argsort(key, axis=1)[:, :KNN_K + 1], 1)
        gap = float(np.diff(ranked, axis=1).min())
        want = np.take_along_axis(ip if metric == "IP" else l2, order, 1)
        for block in (32768, 300):  # one block, and chunks merged on the card
            index = knn.FlatIndex(torch.as_tensor(gallery, device=device), metric,
                                  gallery_block=block)
            scores, idxs = index.search(torch.as_tensor(queries, device=device), KNN_K)
            err = float(np.abs(scores - want).max())
            same = bool(np.array_equal(idxs, order))
            print(f"FlatIndex {metric} on the card (gallery {n}x{d}, 512 queries, k {KNN_K}, "
                  f"gallery_block {block}) against f64 numpy: indexes identical {same}, max "
                  f"score error {err:.3e} (tol 1e-4), smallest f64 gap among the first "
                  f"{KNN_K + 1} {gap:.3e}", flush=True)
            if gap < 1e-5:
                fail(f"check_knn_index: the inputs have near-ties ({gap:.3e} apart)")
            if not same or not err <= 1e-4:
                fail(f"FlatIndex {metric} differs from f64 numpy: indexes identical {same}, "
                     f"max score error {err:.3e}")
    dup = np.repeat(rng.integers(-3, 4, size=(50, 32)), 4, axis=0).astype(np.float32)
    for metric in ("IP", "L2"):
        _, idxs = knn.FlatIndex(torch.as_tensor(dup, device=device), metric).search(dup, 8)
        d64 = dup.astype(np.float64)
        s64 = d64 @ d64.T
        key = -s64 if metric == "IP" else (d64 * d64).sum(1)[:, None] + \
            (d64 * d64).sum(1)[None, :] - 2 * s64
        want = np.argsort(key, axis=1, kind="stable")[:, :8]
        print(f"FlatIndex {metric} on the card, 50 integer vectors 4 times each: ties to the "
              f"lower index {bool(np.array_equal(idxs, want))}", flush=True)
        if not np.array_equal(idxs, want):
            fail(f"FlatIndex {metric}: duplicated vectors do not tie to the lower index")

    index = knn.FlatIndex(torch.as_tensor(gallery, device=device), "IP")
    flat_ms = timed_search(index, torch.as_tensor(gallery, device=device), KNN_K)
    print(f"FlatIndex IP search of the {n} x {d} gallery by all its rows (k {KNN_K}): "
          f"{flat_ms:.4f} ms (median of 5, wall clock, results on the host) on {card_line()}",
          flush=True)

    clusters, per, d = IVF_GALLERY
    big = torch.as_tensor(_clustered(rng, clusters, per, d, 0.05), device=device)
    pick = torch.as_tensor(rng.choice(len(big), size=2048, replace=False), device=device)
    probes = big[pick] + 0.025 * torch.randn((2048, d), device=device,
                                             generator=torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = knn.IvfIndex(big)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    exact = knn.FlatIndex(big)
    want = exact.search(probes, 1)[1]
    got = ivf.search(probes, 1)[1]
    recall = float(np.mean(got[:, 0] == want[:, 0]))
    exact_ms = timed_search(exact, probes, 10)
    ivf_ms = timed_search(ivf, probes, 10)
    print(f"IvfIndex on the card ({len(big)} x {d} clustered, nlist {ivf.nlist}, nprobe "
          f"{ivf.nprobe}, cell capacity {ivf.members.shape[1]}): built in {build_s:.3f} s; "
          f"recall@1 against the exact index {recall:.4f} (floor 0.9) over 2048 queries; "
          f"search (k 10) {ivf_ms:.4f} ms against the exact index's {exact_ms:.4f} ms (median "
          f"of 5, wall clock) on {card_line()}", flush=True)
    if not recall >= 0.9:
        fail(f"IvfIndex recall@1 {recall:.4f} below 0.9")
    if dict(knn.SEARCHES).get("cpu"):
        fail(f"check_knn_index: searches ran on the host: {dict(knn.SEARCHES)}")
    print(f"kNN index phase: {time.perf_counter() - start:.1f} s", flush=True)


def witness_jaccard(preds, targets, num_classes, ignore_index):
    """JaccardIndex recounted in numpy from one validation's logits
    ``(N, C, H, W)`` and pixel labels: the confusion matrix of the argmax over
    the classes, the per-class IoU in f32 and their mean over all
    ``num_classes`` (the ignored class included), summed in order and times
    1/C in f32, as the JAX package's ``jnp.mean`` of up to 16 values
    gives it on the CPU."""
    import numpy as np
    hard = np.argmax(preds, axis=1).reshape(-1)
    truth = targets.reshape(-1)
    keep = truth != ignore_index
    cm = np.bincount(truth[keep] * num_classes + hard[keep],
                     minlength=num_classes ** 2).reshape(num_classes, num_classes)
    cm = cm.astype(np.float32)
    tp = np.diag(cm)
    iou = tp / np.maximum(cm.sum(0) + cm.sum(1) - tp, np.float32(1e-12))
    total = np.float32(0.0)
    for value in iou:
        total = np.float32(total + value)
    return float(np.float32(total * np.float32(1.0 / num_classes)))


def run_segmentation_recipe():
    """``configs/segmentation_shapes.yaml`` at its short budget through
    ``run(..., "train")`` as a user runs it (hrnet_w18_small +
    HRNetSegmentationNeck + SegmentationHead at 32x32, CE + Dice, f32 with TF32
    off, ``steps_per_execution`` 8, 4 loader workers, CSVLogger,
    FinalizeLogger): the reference's JaccardIndex, its step count, the
    JaccardIndex after each epoch, and the last validation's JaccardIndex
    recounted in numpy (``witness_jaccard``) from the logits and labels the
    meter was given, the labels also held to the VALID dataset's masks. The
    JAX HRNet, necks, head and losses reach no Pallas kernel, so every
    hand-written counter stays at 0."""
    import csv
    import tempfile
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor import DATASETS, METRICS
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    # the logits and labels of each JaccardIndex update since its last compute
    meter = METRICS.get("JaccardIndex")
    update, compute, seen, kept = meter.update, meter.compute, [], {}

    def keep_inputs(self, state, preds, target, **kwargs):
        seen.append((preds.detach().cpu().numpy(), target.detach().cpu().numpy()))
        return update(self, state, preds=preds, target=target, **kwargs)

    def keep_last(self, state):
        kept["inputs"] = list(seen)
        seen.clear()
        return compute(self, state)

    with tempfile.TemporaryDirectory(prefix="segmentation_") as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        meter.update, meter.compute = keep_inputs, keep_last
        try:
            trainer, logs = run(segmentation_config(os.path.join(tmp, "train")), "train")
        finally:
            # JaccardIndex inherits update and defines compute
            del meter.update
            meter.compute = compute
        torch.cuda.synchronize()
        require_launches("segmentation recipe train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        jaccard = logs.get("valid/JaccardIndex", float("nan"))
        floor = SEGMENTATION_REFERENCE - SEGMENTATION_TOLERANCE
        with open(os.path.join(trainer.logger.log_dir, "metrics.csv"), newline="") as f:
            epochs = [float(r["valid/JaccardIndex"]) for r in csv.DictReader(f)
                      if r.get("valid/JaccardIndex")]
        print(f"segmentation recipe (hrnet_w18_small + HRNetSegmentationNeck + "
              f"SegmentationHead, CE + Dice, short budget): valid/JaccardIndex={jaccard:.6f} at "
              f"global_step {trainer.global_step} (the reference's short budget 0.838, floor "
              f"{floor:.4f}; at most 10/11 with the ignored class in the mean); by epoch "
              f"{[round(v, 6) for v in epochs]}; smoke train img/s "
              f"{stats['images'] / stats['seconds']:.2f} (a smoke reading: host clock, first "
              f"fetch to each epoch's loss read-back, {stats['steps']} steps, {stats['images']} "
              f"images in {stats['seconds']:.3f} s, bs128 x 8 per execution, f32); eval img/s "
              f"{evals['images'] / evals['seconds']:.2f} (the last validation, {evals['images']} "
              f"images in {evals['seconds']:.3f} s, host clock incl. the metric's read-back); "
              f"peak device memory {peak / 2**20:.1f} MiB on {card_line()}", flush=True)
        if not jaccard >= floor:
            fail(f"segmentation recipe: valid/JaccardIndex {jaccard:.4f} below {floor:.4f}")
        if trainer.global_step != SEGMENTATION_STEPS or stats["steps"] != SEGMENTATION_STEPS:
            fail(f"segmentation recipe: {trainer.global_step} steps ({stats['steps']} run), "
                 f"expected {SEGMENTATION_STEPS}")
        if len(epochs) != 5 or epochs[-1] != jaccard:
            fail(f"segmentation recipe: metrics.csv holds valid/JaccardIndex {epochs}, expected "
                 f"5 epochs ending at {jaccard}")

        valid = SEGMENTATION_RECIPE["data"]["VALID"][0]["dataset"]["params"]
        masks = DATASETS.get("SyntheticShapesSegmentationDataset")(None, **valid).masks
        preds = np.concatenate([p for p, _ in kept["inputs"]])
        targets = np.concatenate([t for _, t in kept["inputs"]])
        if not np.array_equal(targets, masks):
            fail("segmentation recipe: the labels JaccardIndex was given are not the VALID "
                 "dataset's masks")
        params = SEGMENTATION_RECIPE["metrics"][0]["params"]
        witness = witness_jaccard(preds, targets, params["num_classes"], params["ignore_index"])
        print(f"segmentation recipe: valid/JaccardIndex recounted in numpy from the last "
              f"validation's {preds.shape} logits and the dataset's masks {witness:.12f} "
              f"against the meter's {jaccard:.12f} (tol 1e-9)", flush=True)
        if not abs(witness - jaccard) <= 1e-9:
            fail(f"segmentation recipe: valid/JaccardIndex {jaccard} differs from its numpy "
                 f"witness {witness}")
        with open(os.path.join(trainer.logger.log_dir, "status.txt")) as f:
            status = f.read()
        if status != "success":
            fail(f"segmentation recipe: status.txt reads {status!r}")
    print(f"segmentation recipe phase: {time.perf_counter() - start:.1f} s", flush=True)


def witness_map50(batches, num_classes, iou_thr=0.5):
    """VOC-area mAP recounted in numpy from one validation's padded
    ``(preds, target)`` batches (the arrays MMDetectionMAP was given):
    detections of a class taken in descending score order (ties in image
    order, then slot order), each paired with its image's GT of the highest
    IoU, a true positive when that IoU reaches ``iou_thr`` and the GT is not
    yet taken; AP the area under the precision envelope, recall and
    precision in f32 as the meter's f32 counts give them; the mean over the
    classes that have GT."""
    import numpy as np
    dets, gts = [], []
    for preds, target in batches:
        for b in range(preds["labels"].shape[0]):
            keep = (preds["labels"][b] >= 0) & (preds["scores"][b] > 0)
            dets.append((preds["bboxes"][b][keep].astype(np.float32), preds["scores"][b][keep],
                         preds["labels"][b][keep]))
            real = target["labels"][b] >= 0
            gts.append((target["bboxes"][b][real].astype(np.float32), target["labels"][b][real]))
    aps = []
    for cls in range(num_classes):
        n_gt = sum(int((labels == cls).sum()) for _, labels in gts)
        if n_gt == 0:
            continue
        entries = [(img, j) for img, (_, _, labels) in enumerate(dets)
                   for j in np.flatnonzero(labels == cls)]
        scores = np.array([dets[img][1][j] for img, j in entries], np.float32)
        taken = [np.zeros(int((labels == cls).sum()), bool) for _, labels in gts]
        tp = np.zeros(len(entries))
        for k in np.argsort(-scores, kind="stable"):
            img, j = entries[k]
            truth = gts[img][0][gts[img][1] == cls]
            if not len(truth):
                continue
            box = dets[img][0][j]
            wh = np.clip(np.minimum(box[2:], truth[:, 2:]) - np.maximum(box[:2], truth[:, :2]),
                         0, None)
            inter = wh[:, 0] * wh[:, 1]
            union = (np.clip(box[2] - box[0], 0, None) * np.clip(box[3] - box[1], 0, None)
                     + np.clip(truth[:, 2] - truth[:, 0], 0, None)
                     * np.clip(truth[:, 3] - truth[:, 1], 0, None) - inter)
            iou = inter / np.maximum(union, 1e-9)
            best = int(np.argmax(iou))
            if iou[best] >= iou_thr and not taken[img][best]:
                taken[img][best] = True
                tp[k] = 1.0
        order = np.argsort(-scores, kind="stable")
        hit = tp[order] == 1.0
        # recall and precision in f32, as the meter's f32 hit counts give them
        hits = np.cumsum(hit).astype(np.float32)
        recall = hits / np.float32(n_gt)
        precision = hits / np.arange(1, len(order) + 1, dtype=np.float32)
        envelope = np.maximum.accumulate(precision[::-1])[::-1].astype(np.float64)
        # each true positive raises recall by one step, at the envelope's height
        steps = np.diff(np.concatenate([[0.0], recall.astype(np.float64)]))
        aps.append(float(np.sum(steps[hit] * envelope[hit])))
    return float(np.mean(aps)) if aps else 0.0


def capture_metric_inputs(name):
    """Patch metric ``name``'s update and compute so each compute leaves the
    host copies of the ``(preds, target)`` batches it was given since the
    last one in the returned dict's ``"last"``; the returned ``restore()``
    undoes the patch."""
    import numpy as np
    from torchok_tpu_torch.constructor import METRICS
    meter = METRICS.get(name)
    update, compute, seen, kept = meter.update, meter.compute, [], {}

    def host(d):
        if not isinstance(d, dict):
            return np.asarray(d.detach().cpu().numpy())
        return {k: np.asarray(v.detach().cpu().numpy()) for k, v in d.items()}

    def keep_inputs(self, state, preds, target, **kwargs):
        seen.append((host(preds), host(target)))
        return update(self, state, preds=preds, target=target, **kwargs)

    def keep_last(self, state):
        kept["last"] = list(seen)
        seen.clear()
        return compute(self, state)

    def restore():
        meter.update, meter.compute = update, compute

    meter.update, meter.compute = keep_inputs, keep_last
    return kept, restore


def ensure_toy_detection(root):
    """The toy set of ``tools/gen_toy_detection.py`` under ``root`` (written
    by :func:`write_toy_detection` unless an earlier phase wrote it): returns
    the images written and the seconds taken (0 and 0.0 when reused)."""
    start = time.perf_counter()
    if os.path.exists(os.path.join(root, TOYDET_SPLITS[-1][0], "ann.csv")):
        return 0, 0.0
    images = sum(write_toy_detection(os.path.join(root, split), split, n, seed)
                 for split, n, seed in TOYDET_SPLITS)
    return images, time.perf_counter() - start


def run_fcos_recipe(toy_root):
    """``configs/detection_toy_fcos.yaml`` at its short budget (8 epochs)
    through ``run(..., "train")`` as a user runs it, from image files on
    disk: the toy set under ``toy_root``, written first as
    ``tools/gen_toy_detection.py`` writes it (:func:`write_toy_detection`),
    then resnet18 + FPN + FCOSHead at 96x96, f32, 4 loader threads, the host
    HorizontalFlip, CSVLogger, FinalizeLogger, under ``trainer.deterministic``
    (``FCOS_PHASE_OVERRIDES``). Checks the reference's
    valid/map50 floor, the step count, map50 after each epoch, and the last validation's map50 recounted
    in numpy (``witness_map50``) from the padded arrays MMDetectionMAP was
    given, to 1e-9. The JAX ResNet, FPN, FCOS head, losses, NMS and mAP
    reach no Pallas kernel, so every hand-written counter stays at 0."""
    import csv
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor.config import apply_override
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    images, written = ensure_toy_detection(toy_root)
    with tempfile.TemporaryDirectory(prefix="fcos_logs_") as tmp:
        kept, restore = capture_metric_inputs("MMDetectionMAP")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        cfg = fcos_config(toy_root, tmp)
        for override in FCOS_PHASE_OVERRIDES:
            key, _, value = override.partition("=")
            apply_override(cfg, key, value)
        try:
            trainer, logs = run(cfg, "train")
        finally:
            restore()
        torch.cuda.synchronize()
        require_launches("fcos recipe train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        map50 = logs.get("valid/map50", float("nan"))
        floor = FCOS_REFERENCE - FCOS_TOLERANCE
        with open(os.path.join(trainer.logger.log_dir, "metrics.csv"), newline="") as f:
            epochs = [float(r["valid/map50"]) for r in csv.DictReader(f) if r.get("valid/map50")]
        print(f"fcos recipe (resnet18 + FPN + FCOSHead on the toy set, {images} PNGs written in "
              f"{written:.2f} s, short budget): valid/map50={map50:.6f} at global_step "
              f"{trainer.global_step} (the reference's short budget {FCOS_REFERENCE}, floor "
              f"{floor:.4f}); by epoch {[round(v, 6) for v in epochs]}; smoke train img/s "
              f"{stats['images'] / stats['seconds']:.2f} (host clock, first fetch to each "
              f"epoch's loss read-back, {stats['steps']} steps, {stats['images']} images in "
              f"{stats['seconds']:.3f} s, bs32, f32, decoded from disk); eval img/s "
              f"{evals['images'] / evals['seconds']:.2f} (the last validation, {evals['images']} "
              f"images in {evals['seconds']:.3f} s, decode + NMS + the metric's host copy); "
              f"peak device memory {peak / 2**20:.1f} MiB; 0 hand-written launches on "
              f"{card_line()}", flush=True)
        if not map50 >= floor:
            fail(f"fcos recipe: valid/map50 {map50:.4f} below {floor:.4f}")
        if trainer.global_step != FCOS_STEPS or stats["steps"] != FCOS_STEPS:
            fail(f"fcos recipe: {trainer.global_step} steps ({stats['steps']} run), expected "
                 f"{FCOS_STEPS}")
        if len(epochs) != 8 or epochs[-1] != map50:
            fail(f"fcos recipe: metrics.csv holds valid/map50 {epochs}, expected 8 epochs "
                 f"ending at {map50}")
        batches = kept["last"]
        if sum(t["labels"].shape[0] for _, t in batches) != TOYDET_SPLITS[1][1]:
            fail(f"fcos recipe: the last validation gave MMDetectionMAP "
                 f"{sum(t['labels'].shape[0] for _, t in batches)} images, expected "
                 f"{TOYDET_SPLITS[1][1]}")
        witness = witness_map50(batches, FCOS_RECIPE["metrics"][0]["params"]["num_classes"])
        print(f"fcos recipe: valid/map50 recounted in numpy from the last validation's padded "
              f"arrays {witness:.12f} against the meter's {map50:.12f} (tol 1e-9)", flush=True)
        if not abs(witness - map50) <= 1e-9:
            fail(f"fcos recipe: valid/map50 {map50} differs from its numpy witness {witness}")
        with open(os.path.join(trainer.logger.log_dir, "status.txt")) as f:
            status = f.read()
        if status != "success":
            fail(f"fcos recipe: status.txt reads {status!r}")
    print(f"fcos recipe phase: {time.perf_counter() - start:.1f} s", flush=True)


FCOS_R50_MUST_MOVE = ("backbone.layer1.0.conv1.weight", "backbone.layer4.2.bn3.weight",
                      "neck.lateral_convs.0.conv.weight", "neck.fpn_convs.4.conv.weight",
                      "bbox_head.cls_convs.3.gn.weight", "bbox_head.conv_cls.bias",
                      "bbox_head.scales.0.scale")


def run_fcos_full_width():
    """The model of ``configs/detection/fcos_resnet50_coco.yaml`` at full
    width (``fcos_r50_config``: swsl_resnet50, FPN 256 from level 1 with two
    extra convs on the outputs, FCOSHead of 80 classes, 4 stacked convs,
    strides 8 to 128, nms_pre 1000, max_per_img 100; 400x672, bs 8, bf16,
    SGD with gradient clipping) on synthetic PNGs written at 400x672:
    FCOS_R50_STEPS train steps and one validation with MMDetectionMAP through
    ``run``, the named parameters moved, every parameter finite; then the
    trained model in f32 on two validation images, card against CPU, over
    every raw head output (each level's class logits, box distances and
    centerness), within 1e-3 of each output's largest magnitude. 0
    hand-written launches."""
    import math
    import tempfile
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def __init__(self):
            self.initial, self.epochs = {}, []

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

        def on_epoch_end(self, trainer, task, logs):
            self.epochs.append(dict(logs))

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fcos_r50_") as tmp:
        write_box_images(os.path.join(tmp, "train"), FCOS_R50_TRAIN, 1)
        write_box_images(os.path.join(tmp, "valid"), FCOS_R50_VALID, 2)
        written = time.perf_counter() - start
        config = fcos_r50_config(tmp)
        recorder = Recorder()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        trainer, logs = run(config, "train", [recorder])
        torch.cuda.synchronize()
        require_launches("fcos_r50 train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        print(f"fcos_r50 (swsl_resnet50 + FPN 256 + FCOSHead 80 classes, {FCOS_R50_SIZE[0]}x"
              f"{FCOS_R50_SIZE[1]}, bs8 bf16, {FCOS_R50_TRAIN + FCOS_R50_VALID} PNGs written in "
              f"{written:.2f} s): train {stats['steps']} steps, {stats['images']} images in "
              f"{stats['seconds']:.3f} s = {stats['images'] / stats['seconds']:.2f} img/s (a "
              f"smoke reading incl. the first steps' cuDNN plans, host clock, decoded from disk); "
              f"eval {evals['images']} images in {evals['seconds']:.3f} s = "
              f"{evals['images'] / evals['seconds']:.2f} img/s (decode, nms_pre 1000 a level, "
              f"NMS to 100, the metric's host copy); peak device memory {peak / 2**20:.1f} MiB; "
              f"logs {logs}; 0 hand-written launches on {card_line()}", flush=True)
        if stats["steps"] != FCOS_R50_STEPS:
            fail(f"fcos_r50: {stats['steps']} train steps, expected {FCOS_R50_STEPS}")
        for key in ("train/loss", "valid/loss", "valid/MMDetMAP_50", "valid/loss_bbox"):
            if not math.isfinite(logs.get(key, float("nan"))):
                fail(f"fcos_r50: {key} missing or not finite in {logs}")
        if not 0.0 <= logs["valid/MMDetMAP_50"] <= 1.0:
            fail(f"fcos_r50: valid/MMDetMAP_50 {logs['valid/MMDetMAP_50']} outside [0, 1]")
        state = trainer.state.model.state_dict()
        for name, value in state.items():
            if not bool(torch.isfinite(value).all().item()):
                fail(f"fcos_r50 train: {name} is not finite")
        still = [k for k in FCOS_R50_MUST_MOVE if torch.equal(state[k], recorder.initial[k])]
        if still:
            fail(f"fcos_r50 train: parameters that never changed: {still}")

        # f32 reference: the trained model on two validation images, the
        # card (cuDNN, TF32 off) against the CPU, every raw head output
        dataset = trainer.task.val_dataloader()[0].dataset
        images = np.stack([dataset[i]["image"] for i in range(2)])
        x = torch.from_numpy(images).float().permute(0, 3, 1, 2).contiguous()
        x = (x / 255.0 - 0.45) / 0.225
        model = trainer.state.model.float().eval()
        with torch.inference_mode():
            feats = model.backbone.forward_features(x.cuda())[-model.num_scales:]
            on_card = [[o.cpu() for o in level] for level in model.bbox_head(model.neck(feats))]
            model = model.cpu()
            feats = model.backbone.forward_features(x)[-model.num_scales:]
            on_cpu = model.bbox_head(model.neck(feats))
        worst = 0.0
        for name, card_levels, cpu_levels in zip(("cls", "bbox", "centerness"), on_card, on_cpu):
            for i, (a, b) in enumerate(zip(card_levels, cpu_levels)):
                err = ((a - b).abs().max() / b.abs().max()).item()
                worst = max(worst, err)
                print(f"fcos_r50 reference (f32, 2 images, card vs CPU): {name} level {i} "
                      f"{tuple(b.shape)} max_abs_err / max|out| = {err:.3e} (tol 1e-3), "
                      f"max|out| {b.abs().max().item():.3e}", flush=True)
        if not worst <= 1e-3:
            fail(f"fcos_r50: head outputs on the card differ from the CPU run by {worst:.3e} "
                 "of their largest magnitude")
    print(f"fcos_r50 phase: {time.perf_counter() - start:.1f} s", flush=True)


def run_detr_recipe(toy_root, seed=None):
    """``configs/detection_toy_detr.yaml`` at its short budget (100 epochs,
    T_max 100) through ``run(..., "train")`` as a user runs it, on the toy set
    under ``toy_root`` (written unless it is there already): resnet18 +
    DETRHead (3 + 3 layers, 128 wide, 64 queries) at 96x96, f32, bs 32,
    ``steps_per_execution`` 4, AdamW with clipping at 0.1, a validation every
    10 epochs, CSVLogger, FinalizeLogger and ModelCheckpoint, from the port's
    own initial weights for the recipe's seed (or ``seed``), with
    ``DETR_PHASE_OVERRIDES`` (``trainer.deterministic=true``). The trained
    model is validated once more with the reference's decoding
    (:func:`detr_reference_validation`: the JAX package's figure counted all
    64 queries of an image, where the recipe's ``test_cfg`` keeps 10), and
    both readings end the output on a ``detr draw`` line that
    :func:`finish_detr_recipe` reads: the gate is on the mean over
    ``DETR_DRAWS``. Checks the step count and both last validations' map50
    recounted in numpy (``witness_map50``) from the padded arrays
    MMDetectionMAP was given, to 1e-9, and times the host's Hungarian
    assignment (``detr.hungarian_assign``: the wait for the cost's copy and
    the solver). Everything is printed before the first check that fails.
    The JAX ResNet and DETR head reach no Pallas kernel, so every
    hand-written counter stays at 0."""
    import csv
    import glob
    import tempfile
    import scipy.optimize
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.models.heads.detection import detr
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    images, written = ensure_toy_detection(toy_root)
    spent = {"calls": 0, "assign": 0.0, "solver": 0.0}
    assign, solver = detr.hungarian_assign, scipy.optimize.linear_sum_assignment

    def timed_assign(cost, valid):
        t0 = time.perf_counter()
        out = assign(cost, valid)
        spent["calls"] += 1
        spent["assign"] += time.perf_counter() - t0
        return out

    def timed_solver(*args, **kwargs):
        t0 = time.perf_counter()
        out = solver(*args, **kwargs)
        spent["solver"] += time.perf_counter() - t0
        return out

    failures = []
    with tempfile.TemporaryDirectory(prefix="detr_logs_") as tmp:
        config = detr_config(toy_root, tmp)
        from torchok_tpu_torch.constructor.config import apply_override
        for override in DETR_PHASE_OVERRIDES:
            key, _, value = override.partition("=")
            apply_override(config, key, value)
        if seed is not None:
            config["seed_params"] = {"seed": seed}
        kept, restore = capture_metric_inputs("MMDetectionMAP")
        detr.hungarian_assign, scipy.optimize.linear_sum_assignment = timed_assign, timed_solver
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        try:
            trainer, logs = run(config, "train")
        finally:
            restore()
            detr.hungarian_assign, scipy.optimize.linear_sum_assignment = assign, solver
        torch.cuda.synchronize()
        require_launches("detr recipe train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        map50 = logs.get("valid/map50", float("nan"))
        with open(os.path.join(trainer.logger.log_dir, "metrics.csv"), newline="") as f:
            epochs = [float(r["valid/map50"]) for r in csv.DictReader(f) if r.get("valid/map50")]
        print(f"detr recipe (resnet18 + DETRHead 3+3 layers, 128 wide, 64 queries on the toy "
              f"set, {images} PNGs written in {written:.2f} s, short budget, the port's own "
              f"seed-{config['seed_params']['seed']} initial weights, overrides "
              f"{DETR_OVERRIDES + DETR_PHASE_OVERRIDES}): valid/map50={map50:.6f} "
              f"at global_step {trainer.global_step} with the recipe's decoding (max_per_img "
              f"10); at the {len(epochs)} validations {[round(v, 6) for v in epochs]}; smoke "
              f"train img/s {stats['images'] / stats['seconds']:.2f} (host clock, first fetch "
              f"to each epoch's loss read-back, {stats['steps']} steps, {stats['images']} "
              f"images in {stats['seconds']:.3f} s, bs32, f32, decoded from disk, 4 steps an "
              f"execution, beside the script's other phases); eval img/s "
              f"{evals['images'] / evals['seconds']:.2f} (the last validation, "
              f"{evals['images']} images in {evals['seconds']:.3f} s); Hungarian assignment "
              f"{spent['calls']} calls (one a train step), host seconds a call "
              f"{spent['assign'] / max(spent['calls'], 1) * 1e3:.3f} ms incl. the wait for the "
              f"cost's copy, of which the solver "
              f"{spent['solver'] / max(spent['calls'], 1) * 1e3:.3f} ms; peak device memory "
              f"{peak / 2**20:.1f} MiB; 0 hand-written launches on "
              f"{card_line()}", flush=True)
        if trainer.global_step != DETR_STEPS or stats["steps"] != DETR_STEPS:
            failures.append(f"{trainer.global_step} steps ({stats['steps']} run), expected "
                            f"{DETR_STEPS}")
        if len(epochs) != DETR_VALIDATIONS or epochs[-1] != map50:
            failures.append(f"metrics.csv holds valid/map50 {epochs}, expected "
                            f"{DETR_VALIDATIONS} validations ending at {map50}")
        if spent["calls"] < DETR_STEPS:
            failures.append(f"{spent['calls']} assignments for {DETR_STEPS} train steps")
        batches = kept["last"]
        if sum(t["labels"].shape[0] for _, t in batches) != TOYDET_SPLITS[1][1]:
            failures.append(f"the last validation gave MMDetectionMAP "
                            f"{sum(t['labels'].shape[0] for _, t in batches)} images, expected "
                            f"{TOYDET_SPLITS[1][1]}")
        witness = witness_map50(batches, DETR_RECIPE["metrics"][0]["params"]["num_classes"])
        print(f"detr recipe: valid/map50 recounted in numpy from the last validation's padded "
              f"arrays {witness:.12f} against the meter's {map50:.12f} (tol 1e-9)", flush=True)
        if not abs(witness - map50) <= 1e-9:
            failures.append(f"valid/map50 {map50} differs from its numpy witness {witness}")
        with open(os.path.join(trainer.logger.log_dir, "status.txt")) as f:
            status = f.read()
        if status != "success":
            failures.append(f"status.txt reads {status!r}")
        if not glob.glob(os.path.join(tmp, "ckpt", "*.ckpt")):
            failures.append("ModelCheckpoint wrote no checkpoint")
        map50_ref, witness_ref = detr_reference_validation(trainer)
        print(f"detr recipe: the trained model validated with the reference's decoding (the "
              f"JAX package's DETRHead reads no test_cfg inside a task: score_thr 0, "
              f"max_per_img 100, so all 64 queries an image): valid/map50={map50_ref:.6f}, "
              f"recounted in numpy {witness_ref:.12f}", flush=True)
        if not abs(witness_ref - map50_ref) <= 1e-9:
            failures.append(f"the reference-decoded map50 {map50_ref} differs from its numpy "
                            f"witness {witness_ref}")
    import resource
    usage = resource.getrusage(resource.RUSAGE_SELF)
    print(f"detr recipe phase: {time.perf_counter() - start:.1f} s, of which this process "
          f"(not its loader workers) ran {usage.ru_utime + usage.ru_stime:.1f} s on the host's "
          f"cores", flush=True)
    if failures:
        fail("detr recipe: " + "; ".join(failures))
    print("detr draw " + json.dumps({"seed": config["seed_params"]["seed"],
                                     "reference": map50_ref, "recipe": map50}), flush=True)


DETR_DETERMINISM_STEPS = 20


def detr_steps_config(toy_root: str, steps: int, deterministic: bool) -> dict:
    """The DETR recipe cut to its first ``steps`` train steps (five
    executions of 4 at 20), no validation, logger or checkpoint, with
    ``trainer.deterministic`` set as given."""
    cfg = detr_config(toy_root, "")
    cfg["trainer"].update(max_epochs=1, limit_train_batches=steps, deterministic=deterministic)
    del cfg["data"]["VALID"], cfg["logger"]
    cfg["callbacks"] = []
    return cfg


def check_detr_determinism(toy_root, steps=DETR_DETERMINISM_STEPS):
    """The toy DETR task for ``steps`` train steps, twice with
    ``trainer.deterministic=true`` and twice with the default, in this
    process: every parameter of the first pair must be bit-equal, and
    ``run`` must leave the global flags as it found them. Prints the tensors
    compared, the largest difference of each pair and each run's seconds."""
    import torch
    from torchok_tpu_torch.__main__ import run
    flags = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    finals, seconds = {}, {}
    for deterministic in (True, False):
        for turn in range(2):
            t0 = time.perf_counter()
            trainer, _ = run(detr_steps_config(toy_root, steps, deterministic), "train")
            torch.cuda.synchronize()
            seconds[deterministic, turn] = time.perf_counter() - t0
            if trainer.global_step != steps:
                fail(f"detr determinism: {trainer.global_step} steps run, expected {steps}")
            finals[deterministic, turn] = {k: v.detach().cpu().clone() for k, v in
                                           trainer.state.model.state_dict().items()}
            after = (torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
            if after != flags:
                fail(f"detr determinism: run() left the flags (deterministic algorithms, "
                     f"cudnn.deterministic, cudnn.benchmark) at {after}, found at {flags}")
    apart = {}
    for deterministic in (True, False):
        a, b = finals[deterministic, 0], finals[deterministic, 1]
        diffs = {k: (a[k].double() - b[k].double()).abs().max().item() for k in a}
        apart[deterministic] = (sum(v > 0 for v in diffs.values()), len(diffs),
                                max(diffs.values()))
    print(f"detr determinism: the toy DETR task for {steps} train steps, twice in one process "
          f"({DETR_RECIPE['task']['params']['backbone_name']} + DETRHead, bs 32, f32, "
          f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')}): "
          f"trainer.deterministic=true {apart[True][0]} of {apart[True][1]} tensors differ "
          f"(largest {apart[True][2]:.3e}; runs {seconds[True, 0]:.2f} and "
          f"{seconds[True, 1]:.2f} s); the default {apart[False][0]} of {apart[False][1]} "
          f"differ (largest {apart[False][2]:.3e}; runs {seconds[False, 0]:.2f} and "
          f"{seconds[False, 1]:.2f} s); the flags restored after each run", flush=True)
    if apart[True][0]:
        fail(f"detr determinism: under trainer.deterministic=true {apart[True][0]} of "
             f"{apart[True][1]} tensors differ between two runs (largest {apart[True][2]:.3e})")


def start_processes(jobs, log_dir):
    """Start each of ``jobs`` (``(name, this script's arguments, environment
    overrides)``) in a process of its own and a process group of its own,
    side by side, its output to ``<log_dir>/<name>.log`` (spaces as
    underscores). All are stopped with their loader workers when this script
    exits. Returns ``[(name, process, log path)]``."""
    import signal
    runs = []
    for name, args, env in jobs:
        log_path = os.path.join(log_dir, f"{name.replace(' ', '_')}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                                    stdout=log, stderr=subprocess.STDOUT,
                                    env={**os.environ, **env}, start_new_session=True)
        runs.append((name, proc, log_path))

    def stop():
        for _, proc, _ in runs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    atexit.register(stop)
    return runs


def wait_processes(runs, limit_s=1100.0):
    """Wait for the processes of :func:`start_processes` until ``limit_s``
    seconds into the script and print their output. Returns the failures
    and ``{name: output}``."""
    failures, texts = [], {}
    for name, proc, log_path in runs:
        try:
            rc = proc.wait(timeout=max(1.0, limit_s - (time.perf_counter() - _START)))
        except subprocess.TimeoutExpired:
            rc = None
        with open(log_path) as f:
            texts[name] = f.read()
        print(f"--- {name} ---\n{texts[name]}", end="", flush=True)
        if rc is None:
            failures.append(f"{name}: its process had not ended {limit_s:.0f} s into the script")
        elif rc != 0:
            failures.append(f"{name}: its process exited with code {rc}")
    return failures, texts


def start_detr_recipe(toy_root, seeds=DETR_DRAWS, log_dir=None):
    """:func:`run_detr_recipe` for each of ``seeds``, and
    :func:`check_detr_determinism`, started by :func:`start_processes`
    (``chip_smoke.py --detr-recipe`` and ``--detr-determinism``), their logs
    under ``log_dir`` (default ``toy_root``): the 6,000 steps of a run are
    bound by the host, so they run beside the rest of the script. Each sets
    ``CUBLAS_WORKSPACE_CONFIG`` when it starts, as ``trainer.deterministic``
    needs it before the first cuBLAS call."""
    jobs = [(f"detr seed {seed}", ["--detr-recipe", toy_root, "--seed", str(seed)], {})
            for seed in seeds]
    jobs.append(("detr determinism", ["--detr-determinism", toy_root], {}))
    return start_processes(jobs, log_dir or toy_root)


def wait_detr_recipe(runs, limit_s=1100.0):
    """:func:`wait_processes` for :func:`start_detr_recipe`'s processes.
    Returns the failures and ``{seed: (map50 with the reference's decoding,
    with the recipe's)}`` from each run's ``detr draw`` line."""
    failures, texts = wait_processes(runs, limit_s)
    readings = {}
    for text in texts.values():
        for line in text.splitlines():
            if line.startswith("detr draw "):
                draw = json.loads(line[len("detr draw "):])
                readings[draw["seed"]] = (draw["reference"], draw["recipe"])
    return failures, readings


def finish_detr_recipe(runs, limit_s=1100.0):
    """:func:`wait_detr_recipe`, then the gate: every run passed its own
    checks, and the mean over ``DETR_DRAWS`` of valid/map50 with the
    reference's decoding is at least ``DETR_REFERENCE - DETR_TOLERANCE``."""
    failures, readings = wait_detr_recipe(runs, limit_s)
    floor = DETR_REFERENCE - DETR_TOLERANCE
    missing = [seed for seed in DETR_DRAWS if seed not in readings]
    if missing:
        failures.append(f"no reading from the draws {missing}")
    else:
        mean = statistics.fmean(readings[seed][0] for seed in DETR_DRAWS)
        print("detr recipe, the gate: valid/map50 of the draws " + ", ".join(
            f"{seed}: {readings[seed][0]:.6f} (recipe's decoding {readings[seed][1]:.6f})"
            for seed in DETR_DRAWS) + f"; the mean with the reference's decoding {mean:.6f} "
            f"(the reference's short budget {DETR_REFERENCE}, floor {floor:.4f}); "
            f"trainer.deterministic=true; {card_line()}", flush=True)
        if not mean >= floor:
            failures.append(f"the mean valid/map50 {mean:.6f} of draws {list(DETR_DRAWS)} (the "
                            f"reference's decoding) is below {floor:.4f}")
    if failures:
        fail("detr recipe: " + "; ".join(failures))


def detr_reference_validation(trainer):
    """One more validation of the trained DETR task with the JAX package's
    decoding inside a task: its ``DETRHead`` reads no ``test_cfg`` there
    (Flax hands the head a FrozenDict, which ``_test_cfg`` takes for no
    config), so every image keeps ``min(100, num_queries)`` boxes at score
    threshold 0, the head's field defaults. Returns map50 and its numpy
    recount."""
    from torchok_tpu_torch.constructor.config_structure import Phase
    task = trainer.task
    head = task.model.bbox_head
    loaders = task.val_dataloader()
    trainer._install_device_fns(loaders, train=False)
    kept, restore = capture_metric_inputs("MMDetectionMAP")
    test_cfg, head.test_cfg = head.test_cfg, None
    try:
        logs = trainer._run_eval(task, trainer._make_eval_step(task), loaders, Phase.VALID)
    finally:
        head.test_cfg = test_cfg
        restore()
        for loader in loaders:
            loader.close()
    return logs["valid/map50"], witness_map50(kept["last"], head.num_classes)


DETR_GCVIT_MUST_MOVE = ("backbone.stem.conv1.weight",
                        "backbone.stages.2.blocks.1.attn.rel_pos.relative_position_bias_table",
                        "bbox_head.input_proj.weight",
                        "bbox_head.transformer.encoder.layers.0.attentions.0.attn.in_proj_weight",
                        "bbox_head.transformer.decoder.layers.5.attentions.1.attn.out_proj.bias",
                        "bbox_head.query_embedding.weight", "bbox_head.fc_cls.bias",
                        "bbox_head.reg_ffn.layers.1.weight")


def run_detr_full_width(records):
    """The model of ``configs/detection/detr_gcvit-t_coco.yaml`` at full
    width (``detr_gcvit_config``: gcvit_tiny, DETRHead 6 + 6 layers, 256
    wide, 100 queries, 80 classes; 400x672, bs 8, bf16, AdamW with the
    recipe's ``paramwise_cfg``, MultiStepLR, the three detection meters)
    through its own COCODetection / HorizontalFlip / FitResize / Normalize /
    PadIfNeeded / ToTensorV2 pipeline, from a synthetic COCO tree
    (:func:`write_coco_tree`): DETR_GCVIT_STEPS train steps, two sanity and
    one validation pass. Checks the hand-written launches (17 K3a + 14 K4 a
    forward, 17 K3b + 14 K5 a train step, all on the tensor cores), the named
    parameters moved, every parameter finite, and prints each parameter
    group's learning rate; then the trained model in f32 on two validation
    images, card against CPU, over every raw head output (every decoder
    layer's class logits and boxes), within 1e-3 of each output's largest
    magnitude."""
    import tempfile
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def __init__(self):
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="detr_gcvit_") as tmp:
        write_coco_tree(tmp)
        written = time.perf_counter() - start
        recorder = Recorder()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        dot.ROUTE_LAUNCHES.clear()
        dot.FWD_ROUTE_LAUNCHES.clear()
        trainer, logs = run(detr_gcvit_config(tmp, os.path.join(tmp, "logs")), "train",
                            [recorder])
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        steps = stats["steps"]
        forwards = steps + 2 + DETR_GCVIT_VALID // DETR_GCVIT_BATCH  # sanity 2, validation 2
        print(f"detr_gcvit (gcvit_tiny + DETRHead 6+6 layers, 256 wide, 100 queries, 80 "
              f"classes, {DETR_GCVIT_SIZE[0]}x{DETR_GCVIT_SIZE[1]}, bs8 bf16, a COCO tree of "
              f"{DETR_GCVIT_TRAIN + DETR_GCVIT_VALID} PNGs written in {written:.2f} s): train "
              f"{steps} steps, {stats['images']} images in {stats['seconds']:.3f} s = "
              f"{stats['images'] / stats['seconds']:.2f} img/s (a smoke reading incl. the first "
              f"steps, host clock, decoded, fit-resized and padded on the host); eval "
              f"{evals['images']} images in {evals['seconds']:.3f} s = "
              f"{evals['images'] / evals['seconds']:.2f} img/s; peak device memory "
              f"{peak / 2**20:.1f} MiB; logs {logs}; launches {counts} on {card_line()}",
              flush=True)
        for group in trainer.bundles[0].optimizer.param_groups:
            print(f"detr_gcvit param group {group['label']}: {len(group['params'])} tensors, "
                  f"lr {group['lr']:.3e}, weight_decay {group.get('weight_decay', 0.0):.3e}",
                  flush=True)
        if steps != DETR_GCVIT_STEPS:
            fail(f"detr_gcvit: {steps} train steps, expected {DETR_GCVIT_STEPS}")
        print(f"detr_gcvit hand-written launches: K3a {counts.get(dot.KERNEL, 0) / forwards:g} "
              f"and K4 {counts.get(dot.KERNEL_GLOBAL, 0) / forwards:g} a forward ({forwards} "
              f"forwards: {steps} train steps, 2 sanity and "
              f"{DETR_GCVIT_VALID // DETR_GCVIT_BATCH} validation batches), K3b "
              f"{counts.get(dot.KERNEL_BWD, 0) / steps:g} and K5 "
              f"{counts.get(dot.KERNEL_GLOBAL_BWD, 0) / steps:g} a train step", flush=True)
        want = {dot.KERNEL: GCVIT_LOCAL * forwards, dot.KERNEL_GLOBAL: GCVIT_GLOBAL * forwards,
                dot.KERNEL_BWD: GCVIT_LOCAL * steps, dot.KERNEL_GLOBAL_BWD: GCVIT_GLOBAL * steps}
        require_launches("detr_gcvit train", counts, want)
        require_fwd_routes("detr_gcvit train", {(dot.KERNEL, "mma"): GCVIT_LOCAL,
                                                (dot.KERNEL_GLOBAL, "mma"): GCVIT_GLOBAL},
                           forwards)
        routes = {k: v for k, v in dot.ROUTE_LAUNCHES.items() if v}
        if routes != {(dot.KERNEL_BWD, "mma"): GCVIT_LOCAL * steps,
                      (dot.KERNEL_GLOBAL_BWD, "mma"): GCVIT_GLOBAL * steps}:
            fail(f"detr_gcvit train: K3b/K5 launches by route {routes}, expected all on mma")
        for key in ("train/loss", "valid/loss", "valid/MMDetMAP_50", "valid/MMDetMAP_75",
                    "valid/CEMAP_map", "valid/loss_cls", "valid/d0.loss_cls"):
            if not math.isfinite(logs.get(key, float("nan"))):
                fail(f"detr_gcvit: {key} missing or not finite in {logs}")
        state = trainer.state.model.state_dict()
        for name, value in state.items():
            if not bool(torch.isfinite(value).all().item()):
                fail(f"detr_gcvit train: {name} is not finite")
        still = [k for k in DETR_GCVIT_MUST_MOVE if torch.equal(state[k], recorder.initial[k])]
        if still:
            fail(f"detr_gcvit train: parameters that never changed: {still}")
        for kernel, count in counts.items():
            records[kernel]["launches"] += count

        # f32 reference: the trained model on two validation images through
        # the recipe's pipeline, the card (kernels, TF32 off) against the CPU
        # (plain versions), every decoder layer's raw outputs
        dataset = trainer.task.val_dataloader()[0].dataset
        x = torch.from_numpy(np.stack([dataset[i]["image"] for i in range(2)]))
        x = x.float().permute(0, 3, 1, 2).contiguous()
        model = trainer.state.model.float().eval()
        with torch.inference_mode():
            feats = model.backbone.forward_features(x.cuda())[-model.num_scales:]
            on_card = [o.cpu() for o in model.bbox_head(feats)]
            model = model.cpu()
            on_cpu = model.bbox_head(model.backbone.forward_features(x)[-model.num_scales:])
        worst = 0.0
        for name, a, b in zip(("cls_scores", "bbox_preds"), on_card, on_cpu):
            err = ((a - b).abs().max() / b.abs().max()).item()
            worst = max(worst, err)
            print(f"detr_gcvit reference (f32, 2 images, card vs CPU): {name} {tuple(b.shape)} "
                  f"max_abs_err / max|out| = {err:.3e} (tol 1e-3), max|out| "
                  f"{b.abs().max().item():.3e}", flush=True)
        if not worst <= 1e-3:
            fail(f"detr_gcvit: head outputs on the card differ from the CPU run by {worst:.3e} "
                 "of their largest magnitude")
    print(f"detr_gcvit phase: {time.perf_counter() - start:.1f} s", flush=True)


SDPA_OPS = {"flash": "_scaled_dot_product_flash_attention",
            "efficient": "_scaled_dot_product_efficient_attention",
            "cudnn": "_scaled_dot_product_cudnn_attention",
            "math": "_scaled_dot_product_attention_math"}


def sdpa_backends(label, config, size, batch=8):
    """Which backend ``F.scaled_dot_product_attention`` took in one bf16
    train step of the model (random weights, ``batch`` images), from the
    ATen ops the profiler records on the host: forward and backward."""
    import torch
    import torchok_tpu_torch  # noqa: F401 — registers the components
    from torch.profiler import ProfilerActivity, profile
    from torchok_tpu_torch.constructor import TASKS
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import merge_structured

    config = merge_structured(config_from_dict(copy.deepcopy(config)))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    task.init_weights(torch.Generator().manual_seed(5))
    model = task.model.cuda().train()
    generator = torch.Generator().manual_seed(6)
    batch_in = {"image": torch.randn((batch, 3, size, size), generator=generator).cuda(),
                "target": torch.randint(0, 1000, (batch,), generator=generator).cuda()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            total, _ = task.compute_loss(model(batch_in))
        total.backward()
        torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    seen = {name: sorted(k for k in keys if op in k) for name, op in SDPA_OPS.items()}
    seen = {name: ops for name, ops in seen.items() if ops}
    print(f"{label} SDPA backend in a bf16 train step (bs{batch}): {sorted(seen)} "
          f"(ATen ops {sorted(o for ops in seen.values() for o in ops)})", flush=True)
    if not seen:
        fail(f"{label}: no scaled_dot_product_attention op in a train step")
    return sorted(seen)


def run_vit_beit_slices(records):
    """bench.py's vit_small_224_bs128 and beit_base_224_bs128 through
    ``run``: test and predict (3 batches each; the f32 logits on the card
    within 1e-3 of the CPU's on two images), a train slice of 6 one-step
    epochs in which every parameter moves, one f32 forward + backward on two
    images against the CPU (every gradient within 1e-3 of the largest), and
    the SDPA backend of a bf16 train step. The JAX ViT and BEiT call no
    Pallas kernel: every counter stays at 0."""
    start = time.perf_counter()
    for label, slice_cfg, train_cfg, probe in (
            ("vit_small_patch16_224", VIT_SLICE_CONFIG, VIT_TRAIN_CONFIG, "blocks.0.attn.qkv"),
            ("beit_base_patch16_224", BEIT_SLICE_CONFIG, BEIT_TRAIN_CONFIG,
             "relative_position_bias_table")):
        phase = time.perf_counter()
        run_slice(label, slice_cfg, {}, records, 224)
        run_train_slice(label, train_cfg, 224, {}, {}, None, records)
        gradient_reference(label, train_cfg, 224, {}, probe)
        sdpa_backends(label, train_cfg, 224)
        print(f"{label} phase: {time.perf_counter() - phase:.1f} s; 0 launches of every "
              "hand-written kernel", flush=True)
    print(f"vit and beit slices: {time.perf_counter() - start:.1f} s", flush=True)


FCOS_VIT_FROZEN = ("backbone.patch_embed.", "backbone.pos_embed", "backbone.cls_token",
                   "backbone.blocks.0.")
FCOS_VIT_MAY_STAY = ("backbone.norm.", "bbox_head.scales.")


def decay_only(initial, steps, lr, weight_decay, momentum, nesterov=False):
    """SGD's trajectory of a parameter whose gradient is zero (``torch.optim.
    SGD``, no dampening), in f64 on the host."""
    p, buf = initial.double(), None
    for _ in range(steps):
        d = weight_decay * p
        buf = d if buf is None else momentum * buf + d
        p = p - lr * (d + momentum * buf if nesterov else buf)
    return p


def run_fcos_vit_full_width():
    """The model of ``configs/detection/fcos_vit-s_coco.yaml`` at full width
    (``fcos_vit_config``: vit_small_patch16_224, FPN 256 from level 1 with two
    extra convs on the outputs, FCOSHead of 80 classes; 400x672, bs 8, bf16,
    SGD with the recipe's ``paramwise_cfg`` and clipping at 35) under the
    recipe's FreezeUnfreeze (``backbone``, ``stages: 1``) and
    ModelCheckpoint, through COCODetection / HorizontalFlip / FitResize /
    Normalize / PadIfNeeded / ToTensorV2 from a synthetic COCO tree:
    FCOS_VIT_STEPS train steps, the sanity and one validation pass with
    MMDetectionMAP. Checks the frozen set (patch_embed, pos_embed,
    cls_token, blocks.0), that every frozen parameter followed its
    decay-only SGD trajectory recomputed here (one with no decay did not
    move at all), that every other parameter moved (but the backbone's
    final norm, which ``forward_features`` leaves out, as the JAX model
    does, and a level's box scale, which has no decay and a gradient only
    where that level holds a positive sample), the checkpoint files, then
    the trained model in f32 on two validation images, card against CPU,
    over every raw head output, within 1e-3 of each output's largest
    magnitude. 0 hand-written launches."""
    import tempfile
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def __init__(self):
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fcos_vit_") as tmp:
        write_coco_tree(tmp, (("train2017", FCOS_VIT_TRAIN, 3), ("val2017", FCOS_VIT_VALID, 4)))
        written = time.perf_counter() - start
        recorder = Recorder()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        log_dir = os.path.join(tmp, "logs")
        trainer, logs = run(fcos_vit_config(tmp, log_dir), "train", [recorder])
        torch.cuda.synchronize()
        require_launches("fcos_vit train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        model = trainer.state.model
        frozen = trainer.state.frozen_params
        print(f"fcos_vit (vit_small_patch16_224 + FPN 256 + FCOSHead 80 classes, "
              f"{FCOS_VIT_SIZE[0]}x{FCOS_VIT_SIZE[1]}, bs8 bf16, FreezeUnfreeze backbone "
              f"stages 1, a COCO tree of {FCOS_VIT_TRAIN + FCOS_VIT_VALID} PNGs written in "
              f"{written:.2f} s): train {stats['steps']} steps, {stats['images']} images in "
              f"{stats['seconds']:.3f} s = {stats['images'] / stats['seconds']:.2f} img/s (a "
              f"smoke reading incl. the first steps, host clock, decoded, fit-resized and padded "
              f"on the host); eval {evals['images']} images in {evals['seconds']:.3f} s = "
              f"{evals['images'] / evals['seconds']:.2f} img/s; peak device memory "
              f"{peak / 2**20:.1f} MiB; {len(frozen)} parameter tensors frozen "
              f"({sum(p.numel() for n, p in model.named_parameters() if n in frozen)} values); "
              f"logs {logs}; 0 hand-written launches on {card_line()}", flush=True)
        if stats["steps"] != FCOS_VIT_STEPS:
            fail(f"fcos_vit: {stats['steps']} train steps, expected {FCOS_VIT_STEPS}")
        for key in ("train/loss", "valid/loss", "valid/MMDetMAP_50", "valid/loss_bbox"):
            if not math.isfinite(logs.get(key, float("nan"))):
                fail(f"fcos_vit: {key} missing or not finite in {logs}")
        want = {n for n, _ in model.named_parameters() if n.startswith(FCOS_VIT_FROZEN)}
        if frozen != want:
            fail(f"fcos_vit: frozen {sorted(frozen ^ want)[:8]}... differ from the recipe's "
                 "stage-1 policy")
        ckpts = sorted(os.listdir(os.path.join(log_dir, "ckpt")))
        if "last.ckpt" not in ckpts or len(ckpts) != 2:
            fail(f"fcos_vit: checkpoint files {ckpts}, expected the best one and last.ckpt")
        group_of = {id(p): g for g in trainer.bundles[0].optimizer.param_groups
                    for p in g["params"]}
        worst, decayed, still, unmoved = 0.0, 0, 0, []
        for name, p in model.named_parameters():
            value, initial = p.detach().cpu(), recorder.initial[name].cpu()
            if not bool(torch.isfinite(value).all().item()):
                fail(f"fcos_vit train: {name} is not finite")
            if name not in frozen:
                if not torch.equal(value, initial) and name.startswith("backbone.norm."):
                    fail(f"fcos_vit train: {name} moved though no forward uses it")
                if torch.equal(value, initial):
                    unmoved.append(name)
                continue
            group = group_of[id(p)]
            if not group["weight_decay"]:
                still += 1
                if not torch.equal(value, initial):
                    fail(f"fcos_vit: frozen {name} with no decay moved")
                continue
            decayed += 1
            traj = decay_only(initial, FCOS_VIT_STEPS, group["lr"], group["weight_decay"],
                              group["momentum"])
            # f32 roundings: two an update, eight updates
            err = ((value.double() - traj).abs() / (traj.abs() + 1e-30)).max().item()
            worst = max(worst, err)
            if not err <= 16 * 2.0 ** -24 or torch.equal(value, initial):
                fail(f"fcos_vit: frozen {name} left its decay-only trajectory ({err:.3e} "
                     "relative) or did not move")
        # a level's scale has no decay and a gradient only where that level
        # holds a positive sample; the backbone's final norm is in no forward
        stuck = [n for n in unmoved if not n.startswith(FCOS_VIT_MAY_STAY)]
        if stuck:
            fail(f"fcos_vit train: unfrozen parameters that never changed: {stuck[:8]}")
        print(f"fcos_vit freeze check: {decayed} frozen tensors on their decay-only SGD "
              f"trajectory within {worst:.3e} relative (tol 16 x 2^-24), {still} frozen tensors "
              f"without decay unchanged, every other parameter moved but {unmoved} "
              f"(allowed: {FCOS_VIT_MAY_STAY})", flush=True)

        dataset = trainer.task.val_dataloader()[0].dataset
        x = torch.from_numpy(np.stack([dataset[i]["image"] for i in range(2)]))
        x = x.float().permute(0, 3, 1, 2).contiguous()
        model = model.float().eval()
        with torch.inference_mode():
            feats = model.backbone.forward_features(x.cuda())[-model.num_scales:]
            on_card = [[o.cpu() for o in level] for level in model.bbox_head(model.neck(feats))]
            model = model.cpu()
            feats = model.backbone.forward_features(x)[-model.num_scales:]
            on_cpu = model.bbox_head(model.neck(feats))
        worst = 0.0
        for name, card_levels, cpu_levels in zip(("cls", "bbox", "centerness"), on_card, on_cpu):
            for i, (a, b) in enumerate(zip(card_levels, cpu_levels)):
                err = ((a - b).abs().max() / b.abs().max()).item()
                worst = max(worst, err)
                print(f"fcos_vit reference (f32, 2 images, card vs CPU): {name} level {i} "
                      f"{tuple(b.shape)} max_abs_err / max|out| = {err:.3e} (tol 1e-3), "
                      f"max|out| {b.abs().max().item():.3e}", flush=True)
        if not worst <= 1e-3:
            fail(f"fcos_vit: head outputs on the card differ from the CPU run by {worst:.3e} "
                 "of their largest magnitude")
    print(f"fcos_vit phase: {time.perf_counter() - start:.1f} s", flush=True)


def unzero_and_calibrate(model, images):
    """HRNet's blocks at unit last-norm scale (``unzero_last_norms``) and its
    norms at the images' statistics (``calibrate_norms``): unit scales alone
    grow the logits through the fuse layers' sums to order 1e8."""
    unzero_last_norms(model, images)
    calibrate_norms(model, images)


RESUME_EPOCHS = 3


def run_resume_phase(records):
    """Resume on a kernel path: swinv2_tiny's smoke train config (one batch
    repeated, bs 128, bf16) with ModelCheckpoint(save_last), three one-step
    epochs run twice uninterrupted, and once as two epochs and a resume from
    ``last.ckpt`` for the third. Every run launches exactly its K1 and K2
    count and no plain call; the resumed run's parameters and Adam moments
    must equal the uninterrupted run's bit for bit where the two
    uninterrupted runs are bit-equal to each other."""
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
    from torchok_tpu_torch.ops import swin_attention as swin
    from torchok_tpu_torch.ops.common import LAUNCHES

    def fit(cfg, forwards, steps, dirpath):
        LAUNCHES.clear()
        trainer, _ = run(cfg, "train", [ModelCheckpoint(dirpath=dirpath, save_last=True)])
        torch.cuda.synchronize()
        counts = launch_counts()
        require_launches(f"resume phase run ({forwards} forwards, {steps} steps)", counts,
                         {swin.KERNEL: 12 * forwards, swin.KERNEL_BWD: 12 * steps})
        for kernel, count in counts.items():
            records[kernel]["launches"] += count
        moments = trainer.state.optimizers[0].state_dict()["state"]
        out = {f"param {k}": v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
        for index, state in moments.items():
            out[f"exp_avg {index}"] = state["exp_avg"].cpu()
            out[f"exp_avg_sq {index}"] = state["exp_avg_sq"].cpu()
        return trainer, out

    start = time.perf_counter()
    cfg = smoke_train_config(RESUME_EPOCHS)
    first = copy.deepcopy(cfg)
    first["trainer"]["max_epochs"] = RESUME_EPOCHS - 1
    with tempfile.TemporaryDirectory(prefix="resume_") as tmp:
        # validation runs once, after the third epoch; one sanity batch first
        _, whole = fit(cfg, RESUME_EPOCHS + 2, RESUME_EPOCHS, os.path.join(tmp, "a"))
        _, again = fit(cfg, RESUME_EPOCHS + 2, RESUME_EPOCHS, os.path.join(tmp, "b"))
        fit(first, RESUME_EPOCHS, RESUME_EPOCHS - 1, os.path.join(tmp, "c"))
        cfg["resume_path"] = os.path.join(tmp, "c", "last.ckpt")
        trainer, resumed = fit(cfg, 3, 1, os.path.join(tmp, "d"))
    if (trainer.global_step, trainer.current_epoch) != (RESUME_EPOCHS, RESUME_EPOCHS - 1):
        fail(f"resume phase: the resumed run ended at step {trainer.global_step}, epoch "
             f"{trainer.current_epoch}")
    if set(whole) != set(resumed) or set(whole) != set(again):
        fail("resume phase: the runs hold different parameters or moments")
    noise = {k: (whole[k] - again[k]).abs().max().item() for k in whole}
    apart = {k: (whole[k] - resumed[k]).abs().max().item() for k in whole}
    worst_noise = max(noise, key=noise.get)
    worst = max(apart, key=apart.get)
    if not any(noise.values()):
        print(f"resume phase: the two uninterrupted runs are bit-equal, and the resumed run "
              f"{'is' if not any(apart.values()) else 'is NOT'} bit-equal to them "
              f"({len(whole)} parameters and moments; largest difference {apart[worst]:.3e} "
              f"at {worst})", flush=True)
        if any(apart.values()):
            fail(f"resume phase: the resumed run differs from the uninterrupted one by "
                 f"{apart[worst]:.3e} at {worst}")
    else:
        over = [k for k in whole if apart[k] > noise[k]]
        print(f"resume phase: the two uninterrupted runs differ (largest {noise[worst_noise]:.3e} "
              f"at {worst_noise}); the resumed run against them: largest {apart[worst]:.3e} at "
              f"{worst}; {len(over)} of {len(whole)} tensors beyond the two runs' own "
              f"difference", flush=True)
        if over:
            fail(f"resume phase: {len(over)} tensors of the resumed run lie further from the "
                 f"uninterrupted run than the two uninterrupted runs from each other, e.g. "
                 f"{over[:3]}")
    print(f"resume phase: {time.perf_counter() - start:.1f} s", flush=True)


# the new device paths held to their CPU paths on a card batch: (name, params)
AUGMENT_DEVICE_CASES = (
    ("HorizontalFlip", {}), ("VerticalFlip", {}), ("GaussNoise", {"p": 0.7}),
    ("ColorJitter", {**_SWEET_PEPPER_JITTER["params"], "p": 0.7}), ("FancyPCA", {"p": 0.7}),
    ("ElasticTransform", {"border_mode": 1, "p": 0.7}),
    ("ElasticTransform", {"alpha": 40.0, "sigma": 5.0, "p": 0.7}),
    ("GridDistortion", {"p": 0.7}), ("GridDistortion", {"border_mode": 0, "interpolation": 0}))
# uint8 outputs of the non-flips may round one level apart on the card (its
# float32 reductions and products sum in other orders), on at most this share
AUGMENT_LEVEL_SHARE = 0.01
AUGMENT_FLOAT_TOL = 1e-4


def check_augment_devices(images, masks, device):
    """Each new device path (``AUGMENT_DEVICE_CASES``, and OneOf and SomeOf
    over GaussNoise, ColorJitter and VerticalFlip) on a batch on the card
    against the same on the CPU, both drawing from one CPU generator seeded
    alike, so the draws are the same (``device`` the card): uint8 and
    float32 images (float ones
    in [0, 1]), masks exact. Flips and masks must be equal; other uint8
    images within one level on at most ``AUGMENT_LEVEL_SHARE`` of the
    values, float ones within ``AUGMENT_FLOAT_TOL``."""
    import numpy as np
    import torch
    from torchok_tpu_torch.constructor import TRANSFORMS
    cases = [(name, TRANSFORMS.get(name)(**params)) for name, params in AUGMENT_DEVICE_CASES]
    for kind, extra in (("OneOf", {}), ("SomeOf", {"n": 1})):
        kids = [TRANSFORMS.get("GaussNoise")(p=0.5), TRANSFORMS.get("ColorJitter")(),
                TRANSFORMS.get("VerticalFlip")(p=1.0)]
        cases.append((kind, TRANSFORMS.get(kind)(transforms=kids, p=0.8, **extra)))
    for dtype in ("uint8", "float32"):
        x = torch.from_numpy(images)
        x = x if dtype == "uint8" else x.float() / 255.0
        host = {"image": x, "mask": torch.from_numpy(masks)}
        card = {k: v.to(device) for k, v in host.items()}
        for i, (name, t) in enumerate(cases):
            want = t.apply_batch(host, torch.Generator().manual_seed(i))
            got = t.apply_batch(card, torch.Generator().manual_seed(i))
            torch.cuda.synchronize()
            if not torch.equal(got["mask"].cpu(), want["mask"]):
                fail(f"augment devices: {name} ({dtype}) moved the masks otherwise on the card")
            a, b = got["image"].cpu(), want["image"]
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"augment devices: {name} ({dtype}) gave {a.dtype} {tuple(a.shape)} on the "
                     f"card, {b.dtype} {tuple(b.shape)} on the CPU")
            diff = (a.double() - b.double()).abs()
            worst, share = diff.max().item(), (diff > 0).double().mean().item()
            print(f"augment devices: {name} ({dtype}) card vs CPU, same draws: largest "
                  f"difference {worst:.3e} on {share:.2e} of the values", flush=True)
            flip = name.endswith("Flip")
            if dtype == "uint8" and not (worst == 0 if flip else
                                         worst <= 1 and share <= AUGMENT_LEVEL_SHARE):
                fail(f"augment devices: {name} (uint8) differs by {worst} on {share:.2e} of the "
                     f"values")
            if dtype == "float32" and not worst <= (0 if flip else AUGMENT_FLOAT_TOL):
                fail(f"augment devices: {name} (float32) differs by {worst:.3e}")
            if not flip and np.array_equal(a.numpy(), host["image"].numpy()):
                fail(f"augment devices: {name} ({dtype}) left every image as it was")


def time_host_transforms(images, masks, reps=3):
    """Host ms a sample of each transform of the sweet-pepper TRAIN pipeline
    (each OneOf child forced), on 256x256 uint8 samples, in this process."""
    import numpy as np
    from torchok_tpu_torch.constructor.constructor import Constructor
    from torchok_tpu_torch.data.transforms.base import sample_generator
    pipeline = Constructor._create_transforms(_SWEET_PEPPER_AUGMENT + _SWEET_PEPPER_TRANSFORM)
    named = [(type(t).__name__, t, False) for t in pipeline.transforms]
    named += [(f"OneOf/{type(t).__name__}", t, True) for t in pipeline.transforms[3].transforms]
    named.append(("whole pipeline", pipeline, False))
    out = {}
    for name, t, force in named:
        start = time.perf_counter()
        for r in range(reps):
            for i in range(len(images)):
                with sample_generator(np.random.default_rng([r, i])):
                    t(force_apply=force, image=images[i], mask=masks[i])
        out[name] = (time.perf_counter() - start) * 1e3 / (reps * len(images))
    return out


def run_augment_recipe():
    """The TRAIN pipeline of ``configs/segmentation_sweet_pepper.yaml``
    (HorizontalFlip, VerticalFlip, Compose(p 0.5) of PadIfNeeded and
    CenterCrop, two OneOf(p 1) over ElasticTransform(border_mode 1),
    GridDistortion, GaussNoise and ColorJitter, then Resize(256, nearest),
    Normalize and ToTensorV2), verbatim, with the recipe's model at full
    width (hrnet_w18 + HRNetSegmentationNeck + SegmentationHead of 3
    classes at 256x256, bs 8, f32, CE + Dice, Adam 1e-4), through ``run(...,
    "train")`` on PNG images and gray PNG masks the script writes
    (``write_sweet_pepper_tree``, read by ``SweetPepper``) in 4 loader
    worker processes: one epoch of ``SWEET_PEPPER_STEPS`` steps and one
    validation (the cuts printed), with the recipe's ModelCheckpointWithOnnx. The two OneOfs stay on the host (their
    warps need one input shape), so the loader workers run the warps in
    numpy. Checks: each new device path on the card against its CPU path
    (:func:`check_augment_devices`); a finite loss and JaccardIndex, the
    step count, every parameter moved; no cv2, jax or torchok_tpu in this
    process or in a loader worker; an artifact beside each checkpoint,
    replaying the VALID images (``check_artifacts``). Prints the host ms a sample of each
    transform, train img/s and peak memory beside the card's line. The JAX
    HRNet and transforms reach no Pallas kernel, so every hand-written
    counter stays at 0."""
    import tempfile
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    parts = {}  # the phase's seconds by part

    def lap(name):
        parts[name] = time.perf_counter() - start - sum(parts.values())

    card = card_line()
    images, masks = sweet_pepper_arrays(16, True)
    check_augment_devices(images[:8], masks[:8], torch.device("cuda", 0))
    lap("device checks")
    host_ms = time_host_transforms(images, masks)
    lap("host ms a sample")
    print("augment recipe: host ms a sample (256x256 uint8, in this process): "
          + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items()) + f" on {card}", flush=True)

    class Recorder(Callback):
        def __init__(self):
            self.initial = {}

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.named_parameters()}

    recorder = Recorder()
    with tempfile.TemporaryDirectory(prefix="sweet_pepper_") as tmp, ExportTimes() as exports:
        write_sweet_pepper_tree(tmp)
        lap("PNGs written")
        cfg, cuts = sweet_pepper_config(os.path.join(tmp, "logs"), tmp)
        print(f"augment recipe: configs/segmentation_sweet_pepper.yaml with the cuts {cuts}; "
              f"the PNGs written in {parts['PNGs written']:.2f} s", flush=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        trainer, logs = run(cfg, "train", [recorder])
        torch.cuda.synchronize()
        lap("run (the export in it)")
        require_launches("augment recipe train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats = trainer.last_fit
        loader = trainer.task.train_dataloader()[0]
        loader.worker_processes = True
        batches = iter(loader)
        try:
            batch = next(batches)
            in_worker = loader._pool().submit(modules_loaded).result(timeout=120)
        finally:
            batches.close()
            loader.close()
        moved = {name: not torch.equal(value, recorder.initial[name])
                 for name, value in trainer.state.model.named_parameters()}
        lap("a loader worker's modules")
        saver = next(cb for cb in trainer.callbacks if isinstance(cb, ModelCheckpoint))
        n_ckpts, worst = check_artifacts("augment recipe", trainer, saver)
        lap("replays")
    in_main = modules_loaded()
    loss, jaccard = logs.get("train/loss", float("nan")), logs.get("valid/JaccardIndex",
                                                                     float("nan"))
    print(f"augment recipe (hrnet_w18 + HRNetSegmentationNeck + SegmentationHead, 3 classes, "
          f"256x256, bs 8, f32): train/loss={loss:.6f}, valid/JaccardIndex={jaccard:.6f} after "
          f"{trainer.global_step} steps; smoke train img/s {stats['images'] / stats['seconds']:.2f}"
          f" (host clock, first fetch to the epoch's loss read-back, {stats['images']} images in "
          f"{stats['seconds']:.3f} s, 4 loader worker processes running the host pipeline); peak "
          f"device memory {peak / 2**20:.1f} MiB; {sum(moved.values())} of {len(moved)} "
          f"parameters moved; a host batch {batch['image'].dtype} "
          f"{tuple(batch['image'].shape)}; modules loaded of cv2, jax, torchok_tpu: {in_main} "
          f"here, {in_worker} in a loader worker; {n_ckpts} checkpoints with their artifacts, "
          f"ModelCheckpointWithOnnx's exports {', '.join(f'{t:.2f}' for t in exports.seconds)} "
          f"s, largest replay difference {worst:.3e}; 0 hand-written launches; phase "
          f"{time.perf_counter() - start:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") on {card}", flush=True)
    if not (math.isfinite(loss) and math.isfinite(jaccard)):
        fail(f"augment recipe: train/loss {loss} or valid/JaccardIndex {jaccard} not finite")
    if trainer.global_step != SWEET_PEPPER_STEPS or stats["steps"] != SWEET_PEPPER_STEPS:
        fail(f"augment recipe: {trainer.global_step} steps, expected {SWEET_PEPPER_STEPS}")
    if not all(moved.values()):
        fail(f"augment recipe: parameters that did not move: "
             f"{[k for k, v in moved.items() if not v][:5]}")
    if in_main or in_worker:
        fail(f"augment recipe: loaded {in_main} here and {in_worker} in a loader worker")
    if batch["image"].dtype != np.uint8 or tuple(batch["image"].shape) != (8, 256, 256, 3):
        fail(f"augment recipe: the host stage gave {batch['image'].dtype} "
             f"{tuple(batch['image'].shape)}, expected uint8 (8, 256, 256, 3)")


def spatial_arrays(n: int, size: int, seed: int = 0):
    """``n`` uint8 RGB images (n, size, size, 3) with smooth gradients and
    noise, and int32 masks of blobs in three classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    base = np.stack([xx, yy, (xx + yy) / 2], -1) * 200
    images = np.clip(base[None] + rng.normal(0, 25, (n, size, size, 3)), 0, 255).astype(np.uint8)
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        for c, (cy, cx, r) in enumerate(rng.uniform(0.2, 0.8, (3, 3)) * [size, size, size / 3]):
            masks[i][(yy * size - cy) ** 2 + (xx * size - cx) ** 2 < r * r] = c + 1
    return images, masks


def check_spatial_devices(images, masks, device):
    """Each device path of the slice (``SPATIAL_DEVICE_CASES``) on a card
    batch against the same batch on the CPU under the same draws
    (``draw_batch`` on the CPU, ``apply_drawn`` on both): uint8 and float32
    images (float ones in [0, 1]) and masks. Exact cases and every mask must
    be equal; other uint8 images within one level on at most
    ``SPATIAL_LEVEL_SHARE`` of the values, float ones within
    ``SPATIAL_FLOAT_TOL``. Returns the worst (difference, share) of the
    bilinear cases."""
    import torch
    from torchok_tpu_torch.constructor import TRANSFORMS
    worst_all = [0.0, 0.0]
    for i, (name, params, exact) in enumerate(SPATIAL_DEVICE_CASES):
        t = TRANSFORMS.get(name)(**params)
        if not t.device_capable:
            fail(f"spatial devices: {name} {params} has no device path")
        draws = (t.draw_batch(images.shape[:3], torch.Generator().manual_seed(i),
                              torch.device("cpu")) if hasattr(t, "draw_batch") else None)
        for dtype in ("uint8", "float32"):
            x = torch.from_numpy(images)
            x = x if dtype == "uint8" else x.float() / 255.0
            host = {"image": x, "mask": torch.from_numpy(masks)}
            card = {k: v.to(device) for k, v in host.items()}
            if draws is None:
                want, got = t.apply_batch(host, None), t.apply_batch(card, None)
            else:
                want, got = t.apply_drawn(host, *draws), t.apply_drawn(card, *draws)
            torch.cuda.synchronize()
            if not torch.equal(got["mask"].cpu(), want["mask"]):
                fail(f"spatial devices: {name} ({dtype}) moved the masks otherwise on the card")
            a, b = got["image"].cpu(), want["image"]
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"spatial devices: {name} ({dtype}) gave {a.dtype} {tuple(a.shape)} on "
                     f"the card, {b.dtype} {tuple(b.shape)} on the CPU")
            diff = (a.double() - b.double()).abs()
            worst, share = diff.max().item(), (diff > 0).double().mean().item()
            print(f"spatial devices: {name} {params} ({dtype}) card vs CPU, same draws: "
                  f"largest difference {worst:.3e} on {share:.2e} of the values, output "
                  f"{tuple(a.shape)}", flush=True)
            if exact and worst != 0:
                fail(f"spatial devices: {name} ({dtype}) must be equal, differs by {worst}")
            if dtype == "uint8" and not (worst <= 1 and share <= SPATIAL_LEVEL_SHARE):
                fail(f"spatial devices: {name} (uint8) differs by {worst} on {share:.2e}")
            if dtype == "float32" and not worst <= SPATIAL_FLOAT_TOL:
                fail(f"spatial devices: {name} (float32) differs by {worst:.3e}")
            if dtype == "uint8" and not exact:
                worst_all = [max(worst_all[0], worst), max(worst_all[1], share)]
    return worst_all


def time_spatial_host(reps: int = 1, n: int = 8):
    """Host ms a sample of each transform of ``SPATIAL_HOST_CASES`` (forced)
    on uint8 images of 256 to 400 px a side with masks and boxes, and the
    modules of cv2, jax and torchok_tpu loaded; run in a loader worker
    process."""
    import numpy as np
    from torchok_tpu_torch.constructor import TRANSFORMS
    from torchok_tpu_torch.data.transforms.base import sample_generator
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(256, 401, 2))
        image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4:h // 2, w // 5:w // 2] = 1
        mask[2 * h // 3:, 3 * w // 4:] = 2
        boxes = np.array([[w * 0.2, h * 0.25, w * 0.5, h * 0.5]], np.float32)
        samples.append({"image": image, "mask": mask, "bboxes": boxes,
                        "cropping_bbox": [w * 0.3, h * 0.3, w * 0.6, h * 0.7]})
    out = {}
    for name, params in SPATIAL_HOST_CASES:
        t = TRANSFORMS.get(name)(**params)
        keep = [s if t.handles_bboxes or not t.geometric else
                {k: v for k, v in s.items() if k != "bboxes"} for s in samples]
        t(force_apply=True, **keep[0])  # warm-up: lazy imports (scipy for MaskDropout)
        start = time.perf_counter()
        for r in range(reps):
            for i, sample in enumerate(keep):
                with sample_generator(np.random.default_rng([r, i])):
                    t(force_apply=True, **sample)
        out[name] = (time.perf_counter() - start) * 1e3 / (reps * n)
    return out, modules_loaded()


def run_spatial_recipe():
    """The slice's geometry on the card, in three parts. (a) Each device path
    of ``spatial.py`` against its CPU path under the same draws, on 8
    images of 256x256 (:func:`check_spatial_devices`). (b)
    ``configs/classification_swinv2_tiny_spatial_aug_train.yaml``
    (``SPATIAL_TRAIN_CONFIG``) through ``run(..., "train")``: swinv2_tiny at
    full width, bf16, bs 64, ``SPATIAL_STEPS`` steps on uint8 288x288
    images, its TRAIN pipeline (RandomResizedCrop, HorizontalFlip,
    ShiftScaleRotate, Perspective, RandomRotate90, Normalize, ToTensorV2)
    wholly in the device suffix; 12 K1 launches a forward and 12 K2 a step
    and no plain call, a finite loss, the step count, every parameter
    moved but the three pyramid norms no head reads (``SPATIAL_UNUSED``,
    which must stay), the suffix's ms a batch. The launches are printed on
    a ``spatial launches:`` line, which the main process adds to the
    kernels line. (c) The host ms a sample of
    each new host transform in a loader worker process
    (:func:`time_spatial_host`), and no cv2, jax or torchok_tpu in this
    process or that worker."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor.constructor import Constructor
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import swin_attention as swin

    start = time.perf_counter()
    parts = {}  # the phase's seconds by part

    def lap(name):
        parts[name] = time.perf_counter() - start - sum(parts.values())

    card = card_line()
    from torchok_tpu_torch.utils.cuda_build import load_libraries
    load_libraries((swin.KERNEL, swin.KERNEL_BWD))  # built by the main process, or here
    lap("K1 and K2 loaded")
    images, masks = spatial_arrays(8, 256)
    worst = check_spatial_devices(images, masks, torch.device("cuda", 0))
    lap("device paths")

    cfg = copy.deepcopy(SPATIAL_TRAIN_CONFIG)
    dataset = cfg["data"]["TRAIN"][0]["dataset"]
    host, suffix = Constructor._create_transforms(
        copy.deepcopy(dataset["augment"] + dataset["transform"])).split_device_suffix(
        uniform_shapes=True)
    suffix = [type(t).__name__ for t in suffix]
    print(f"spatial recipe: host prefix {[type(t).__name__ for t in host.transforms]}, device "
          f"suffix {suffix}", flush=True)
    if host.transforms or suffix != SPATIAL_SUFFIX:
        fail(f"spatial recipe: the split left {host.transforms} on the host")

    class Recorder(Callback):
        def __init__(self):
            self.initial, self.losses = {}, []

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.named_parameters()}

        def on_train_batch_end(self, trainer, task, step, logs):
            self.losses.append(float(logs["loss"]))

    recorder = Recorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from torchok_tpu_torch.ops.common import LAUNCHES
    LAUNCHES.clear()
    trainer, logs = run(cfg, "train", [recorder])
    torch.cuda.synchronize()
    counts = launch_counts()
    lap("train")
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_fit
    forwards = SPATIAL_STEPS + 2  # one sanity and one validation batch
    require_launches("spatial recipe train", counts,
                     {swin.KERNEL: 12 * forwards, swin.KERNEL_BWD: 12 * SPATIAL_STEPS})
    print("spatial launches: " + json.dumps(counts), flush=True)
    moved = {name: not torch.equal(value, recorder.initial[name])
             for name, value in trainer.state.model.named_parameters()}
    loss = logs.get("train/loss", float("nan"))
    # the device suffix alone on a batch of the run's images, CUDA events
    dataset = trainer.task.train_dataloader()[0].dataset
    card_batch = {k: torch.from_numpy(v).to("cuda") for k, v in
                  dataset.get_batch(np.arange(SPATIAL_BATCH)).items() if k == "image"}
    generator = torch.Generator(device="cuda").manual_seed(0)
    geometry_ms = median_ms(lambda: dataset.device_pipeline(card_batch, generator))
    lap("geometry timed")

    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("forkserver")) as pool:
        host_ms, in_worker = pool.submit(time_spatial_host).result(timeout=300)
    lap("host ms in a worker")
    in_main = modules_loaded()
    print("spatial recipe: host ms a sample (uint8, 256 to 400 px, forced, in a loader worker "
          "process): " + ", ".join(f"{k} {v:.3f}" for k, v in host_ms.items()) + f" on {card}",
          flush=True)
    print(f"spatial recipe (swinv2_tiny_window8_256, 1000 classes, {SPATIAL_SIZE}x{SPATIAL_SIZE} "
          f"uint8 -> 256x256 on the card, bs {SPATIAL_BATCH}, bf16): train/loss={loss:.6f} after "
          f"{trainer.global_step} steps (per step: "
          + " ".join(f"{v:.4f}" for v in recorder.losses) + f"); valid/Accuracy="
          f"{logs.get('valid/Accuracy', float('nan')):.6f}; smoke train img/s "
          f"{stats['images'] / stats['seconds']:.2f} (host clock, {stats['images']} images in "
          f"{stats['seconds']:.3f} s, the geometry on the card); the device suffix "
          f"{geometry_ms:.4f} ms a batch of {SPATIAL_BATCH} (CUDA events, median); peak device "
          f"memory {peak / 2**20:.1f} MiB; launches {counts}, 0 plain calls; "
          f"{sum(moved.values())} of {len(moved)} parameters moved, the {len(moved) - sum(moved.values())} "
          f"unmoved {sorted(k for k, v in moved.items() if not v)}; bilinear card vs CPU worst "
          f"{worst[0]:.0f} level on "
          f"{worst[1]:.2e} of the uint8 values; modules loaded of cv2, jax, torchok_tpu: "
          f"{in_main} here, {in_worker} in a loader worker; phase "
          f"{time.perf_counter() - start:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") on {card}", flush=True)
    if not math.isfinite(loss) or not all(math.isfinite(v) for v in recorder.losses):
        fail(f"spatial recipe: a loss is not finite: {recorder.losses}")
    if trainer.global_step != SPATIAL_STEPS or stats["steps"] != SPATIAL_STEPS:
        fail(f"spatial recipe: {trainer.global_step} steps, expected {SPATIAL_STEPS}")
    wrong = [k for k, v in moved.items() if v == k.startswith(SPATIAL_UNUSED)]
    if wrong:
        fail(f"spatial recipe: parameters that did not move, or moved without a gradient "
             f"path (SPATIAL_UNUSED): {wrong[:5]}")
    if in_main or in_worker:
        fail(f"spatial recipe: loaded {in_main} here and {in_worker} in a loader worker")


def check_photometric_devices(images, masks, device):
    """Each device path of the 27 names (``PHOTOMETRIC_DEVICE_CASES``) on a
    card batch against the same batch on the CPU under the same draws
    (``draw_batch`` on the CPU, ``apply_drawn`` on both; the casts draw
    nothing): uint8 and float32 images (float ones in [0, 1]) and masks.
    Exact cases and every mask must be equal; the others' uint8 images
    within one level on at most ``PHOTOMETRIC_LEVEL_SHARE`` of the values,
    float ones within ``PHOTOMETRIC_FLOAT_TOL``. Returns the worst
    (difference, share) of the uint8 cases that may differ."""
    import numpy as np
    import torch
    from torchok_tpu_torch.constructor import TRANSFORMS
    worst_all = [0.0, 0.0]
    for i, (name, params, exact, dtypes) in enumerate(PHOTOMETRIC_DEVICE_CASES):
        t = TRANSFORMS.get(name)(**params)
        if not t.device_capable:
            fail(f"photometric devices: {name} {params} has no device path")
        draws = (t.draw_batch(images.shape, torch.Generator().manual_seed(i), torch.device("cpu"))
                 if hasattr(t, "draw_batch") else None)
        for dtype in dtypes:
            x = torch.from_numpy(images)
            x = x if dtype == "uint8" else x.float() / 255.0
            host = {"image": x, "mask": torch.from_numpy(masks)}
            card = {k: v.to(device) for k, v in host.items()}
            if draws is None:
                want, got = t.apply_batch(host, None), t.apply_batch(card, None)
            else:
                want, got = t.apply_drawn(host, *draws), t.apply_drawn(card, *draws)
            torch.cuda.synchronize()
            if not torch.equal(got["mask"].cpu(), want["mask"]):
                fail(f"photometric devices: {name} ({dtype}) moved the masks otherwise on the "
                     "card")
            a, b = got["image"].cpu().numpy(), want["image"].numpy()
            if a.dtype != b.dtype or a.shape != b.shape:
                fail(f"photometric devices: {name} ({dtype}) gave {a.dtype} {a.shape} on the "
                     f"card, {b.dtype} {b.shape} on the CPU")
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            worst, share = float(diff.max()), float((diff > 0).mean())
            print(f"photometric devices: {name} {params} ({dtype}) card vs CPU, same draws: "
                  f"largest difference {worst:.3e} on {share:.2e} of the values, output "
                  f"{a.dtype} {a.shape}", flush=True)
            if exact and worst != 0:
                fail(f"photometric devices: {name} ({dtype}) must be equal, differs by {worst}")
            if a.dtype == np.uint8 and not (worst <= 1 and share <= PHOTOMETRIC_LEVEL_SHARE):
                fail(f"photometric devices: {name} (uint8) differs by {worst} on {share:.2e}")
            if a.dtype == np.float32 and not worst <= PHOTOMETRIC_FLOAT_TOL:
                fail(f"photometric devices: {name} (float32) differs by {worst:.3e}")
            if a.dtype == np.uint8 and not exact:
                worst_all = [max(worst_all[0], worst), max(worst_all[1], share)]
    return worst_all


# the error a JPEG round trip raises where libjpeg is missing names it
JPEG_NAMES = ("ImageCompression", "JpegCompression")


def time_photometric_host(reps: int = 1, n: int = 8):
    """Host ms a sample of each transform of ``PHOTOMETRIC_HOST_CASES``
    (forced) on uint8 224x224 images with masks, and which of cv2, jax and
    torchok_tpu are loaded; run in a loader worker process. A JPEG round
    trip either is timed or raises the error that names libjpeg (returned
    as its message instead of a time)."""
    import numpy as np
    from torchok_tpu_torch.constructor import TRANSFORMS
    from torchok_tpu_torch.data.transforms.base import sample_generator
    images, masks = spatial_arrays(n, PHOTOMETRIC_SIZE, seed=5)
    out = {}
    for name, params in PHOTOMETRIC_HOST_CASES:
        t = TRANSFORMS.get(name)(**params)
        samples = [{"image": img if name != "FromFloat" else img / np.float32(255.0),
                    "mask": mask} for img, mask in zip(images, masks)]
        try:
            t(force_apply=True, **samples[0])  # warm-up: lazy tables, the JPEG library
        except RuntimeError as e:
            if name not in JPEG_NAMES or "libjpeg" not in str(e):
                raise
            out[name] = str(e).splitlines()[0]
            continue
        start = time.perf_counter()
        for r in range(reps):
            for i, sample in enumerate(samples):
                with sample_generator(np.random.default_rng([r, i])):
                    t(force_apply=True, **sample)
        out[name] = (time.perf_counter() - start) * 1e3 / (reps * n)
    return out, modules_loaded()


def run_photometric_recipe():
    """The slice's photometric transforms on the card, in three parts. (a)
    Each device path of the 27 names against its CPU path under the same
    draws, on 8 images of 224x224 (:func:`check_photometric_devices`). (b)
    ``configs/classification_gcvit_tiny_photometric_aug_train.yaml``
    (``PHOTOMETRIC_TRAIN_CONFIG``) through ``run(..., "train")``:
    gcvit_tiny at full width, bf16, bs 64, ``PHOTOMETRIC_STEPS`` steps on
    uint8 224x224 images, its TRAIN pipeline (RandomBrightnessContrast,
    HueSaturationValue, CLAHE, RandomGamma, GaussianBlur, MotionBlur,
    Sharpen, CoarseDropout, ToGray, Normalize, ToTensorV2) wholly in the
    device suffix; 17 K3a and 14 K4 launches a forward and 17 K3b and 14
    K5 a step, all on the tensor cores, and no plain call; a finite loss,
    the step count, every parameter moved (gcvit_tiny has none that the
    head does not read), the suffix's ms a batch, whole and by transform.
    The launches are printed
    on a ``photometric launches:`` line, which the main process adds to
    the kernels line. (c) The host ms a sample of each new host transform
    in a loader worker process (:func:`time_photometric_host`), and no cv2,
    jax or torchok_tpu in this process or that worker."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor.constructor import Constructor
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.ops.common import LAUNCHES
    from torchok_tpu_torch.utils.cuda_build import load_libraries

    start = time.perf_counter()
    parts = {}  # the phase's seconds by part

    def lap(name):
        parts[name] = time.perf_counter() - start - sum(parts.values())

    card = card_line()
    load_libraries(dot.KERNELS)  # built by the main process, or here
    lap("K3a, K3b, K4 and K5 loaded")
    images, masks = spatial_arrays(8, PHOTOMETRIC_SIZE)
    worst = check_photometric_devices(images, masks, torch.device("cuda", 0))
    lap("device paths")

    cfg = copy.deepcopy(PHOTOMETRIC_TRAIN_CONFIG)
    dataset = cfg["data"]["TRAIN"][0]["dataset"]
    host, suffix = Constructor._create_transforms(
        copy.deepcopy(dataset["augment"] + dataset["transform"])).split_device_suffix(
        uniform_shapes=True)
    suffix = [type(t).__name__ for t in suffix]
    print(f"photometric recipe: host prefix {[type(t).__name__ for t in host.transforms]}, "
          f"device suffix {suffix}", flush=True)
    if host.transforms or suffix != PHOTOMETRIC_SUFFIX:
        fail(f"photometric recipe: the split left {host.transforms} on the host")

    class Recorder(Callback):
        def __init__(self):
            self.initial, self.losses = {}, []

        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.named_parameters()}

        def on_train_batch_end(self, trainer, task, step, logs):
            self.losses.append(float(logs["loss"]))

    recorder = Recorder()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    dot.ROUTE_LAUNCHES.clear()
    dot.FWD_ROUTE_LAUNCHES.clear()
    trainer, logs = run(cfg, "train", [recorder])
    torch.cuda.synchronize()
    counts = launch_counts()
    lap("train")
    peak = torch.cuda.max_memory_allocated()
    stats = trainer.last_fit
    forwards = PHOTOMETRIC_STEPS + 2  # one sanity and one validation batch
    require_launches("photometric recipe train", counts, {
        dot.KERNEL: GCVIT_LOCAL * forwards, dot.KERNEL_GLOBAL: GCVIT_GLOBAL * forwards,
        dot.KERNEL_BWD: GCVIT_LOCAL * PHOTOMETRIC_STEPS,
        dot.KERNEL_GLOBAL_BWD: GCVIT_GLOBAL * PHOTOMETRIC_STEPS})
    require_fwd_routes("photometric recipe train", {(dot.KERNEL, "mma"): GCVIT_LOCAL,
                                                    (dot.KERNEL_GLOBAL, "mma"): GCVIT_GLOBAL},
                       forwards)
    routes = {k: v for k, v in dot.ROUTE_LAUNCHES.items() if v}
    if routes != {(dot.KERNEL_BWD, "mma"): GCVIT_LOCAL * PHOTOMETRIC_STEPS,
                  (dot.KERNEL_GLOBAL_BWD, "mma"): GCVIT_GLOBAL * PHOTOMETRIC_STEPS}:
        fail(f"photometric recipe train: K3b/K5 launches by route {routes}, expected all on "
             "mma")
    print("photometric launches: " + json.dumps(counts), flush=True)
    moved = {name: not torch.equal(value, recorder.initial[name])
             for name, value in trainer.state.model.named_parameters()}
    loss = logs.get("train/loss", float("nan"))
    # the device suffix alone on a batch of the run's images, CUDA events
    dataset = trainer.task.train_dataloader()[0].dataset
    card_batch = {k: torch.from_numpy(v).to("cuda") for k, v in
                  dataset.get_batch(np.arange(PHOTOMETRIC_BATCH)).items() if k == "image"}
    generator = torch.Generator(device="cuda").manual_seed(0)
    suffix_ms = median_ms(lambda: dataset.device_pipeline(card_batch, generator))
    by_transform, batch = {}, card_batch  # each on what the ones before it give
    for t in dataset.device_pipeline.transforms:
        by_transform[type(t).__name__] = median_ms(lambda: t.apply_batch(batch, generator))
        batch = t.apply_batch(batch, generator)
    print("photometric recipe: the device suffix by transform, ms a batch of "
          f"{PHOTOMETRIC_BATCH} (CUDA events, median): "
          + ", ".join(f"{k} {v:.4f}" for k, v in by_transform.items()) + f" on {card}",
          flush=True)
    lap("suffix timed")

    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("forkserver")) as pool:
        host_ms, in_worker = pool.submit(time_photometric_host).result(timeout=300)
    lap("host ms in a worker")
    in_main = modules_loaded()
    timed = {k: v for k, v in host_ms.items() if not isinstance(v, str)}
    print("photometric recipe: host ms a sample (uint8 224x224, forced, in a loader worker "
          "process): " + ", ".join(f"{k} {v:.3f}" for k, v in timed.items()) + "; "
          + "; ".join(f"{k} raised: {v}" for k, v in host_ms.items() if isinstance(v, str))
          + f" on {card}", flush=True)
    print(f"photometric recipe (gcvit_tiny, 1000 classes, {PHOTOMETRIC_SIZE}x{PHOTOMETRIC_SIZE} "
          f"uint8 photometrically augmented on the card, bs {PHOTOMETRIC_BATCH}, bf16): "
          f"train/loss={loss:.6f} after {trainer.global_step} steps (per step: "
          + " ".join(f"{v:.4f}" for v in recorder.losses) + f"); valid/Accuracy="
          f"{logs.get('valid/Accuracy', float('nan')):.6f}; smoke train img/s "
          f"{stats['images'] / stats['seconds']:.2f} (host clock, {stats['images']} images in "
          f"{stats['seconds']:.3f} s, the photometry on the card); the device suffix "
          f"{suffix_ms:.4f} ms a batch of {PHOTOMETRIC_BATCH} (CUDA events, median); peak "
          f"device memory {peak / 2**20:.1f} MiB; launches {counts}, 0 plain calls; "
          f"{sum(moved.values())} of {len(moved)} parameters moved; card vs CPU worst "
          f"{worst[0]:.0f} level on {worst[1]:.2e} of the uint8 values of the bounded cases; "
          f"modules loaded of cv2, jax, torchok_tpu: {in_main} here, {in_worker} in a loader "
          f"worker; phase {time.perf_counter() - start:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") on {card}", flush=True)
    if not math.isfinite(loss) or not all(math.isfinite(v) for v in recorder.losses):
        fail(f"photometric recipe: a loss is not finite: {recorder.losses}")
    if trainer.global_step != PHOTOMETRIC_STEPS or stats["steps"] != PHOTOMETRIC_STEPS:
        fail(f"photometric recipe: {trainer.global_step} steps, expected {PHOTOMETRIC_STEPS}")
    if not all(moved.values()):
        fail(f"photometric recipe: parameters that did not move: "
             f"{[k for k, v in moved.items() if not v][:5]}")
    if in_main or in_worker:
        fail(f"photometric recipe: loaded {in_main} here and {in_worker} in a loader worker")


def side_launches(text):
    """The kernel launches each side phase printed on its ``<phase>
    launches: {...}`` line (the last of a phase), by phase."""
    return {phase: json.loads(counts) for phase, counts in
            re.findall(r"^(\w+) launches: (\{.*\})$", text, re.M)}


def witness_hit(state, k=1):
    """HitAtKMeter's value recomputed in numpy from the state its last
    ``compute`` was given: the epoch's embeddings normalised by row in f64,
    all inner products, each query's k nearest others (itself left out) in
    descending order, and the queries with a neighbour of their class among
    them counted."""
    import numpy as np
    unit, labels = _unit_rows(state)
    similarity = unit @ unit.T
    np.fill_diagonal(similarity, -np.inf)
    neighbours = np.argsort(-similarity, axis=1, kind="stable")[:, :k]
    return float(np.mean((labels[neighbours] == labels[:, None]).any(1)))


def _unit_rows(state):
    """A retrieval meter state's embeddings as f64 rows of norm 1, and
    their labels."""
    import numpy as np
    import torch
    vectors = torch.cat(state["vectors"]).double().cpu().numpy()
    labels = np.concatenate([np.asarray(t.cpu()) if torch.is_tensor(t) else np.asarray(t)
                             for t in state["group_labels"]])
    return vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12), labels


# embeddings whose directions all lie within this of one another (1 - the
# least cosine of two) are one direction to f32 search, whose inner products
# round at a few times 6e-8: their HitAtKMeter reading is rounding, which no
# recount in other arithmetic reproduces
HIT_RESOLVABLE = 1e-4


def check_hit(label, state, params, device):
    """HitAtKMeter held to :func:`witness_hit` to 1e-9, twice: on the
    epoch's embeddings as the run gave them, where their directions spread
    by ``HIT_RESOLVABLE`` or more (else the reading is printed, not held),
    and on the same embeddings less their mean (in f64, then f32), through
    a new meter of the recipe's ``params`` on ``device``: directions f32
    resolves, with the classes the run's embeddings carry. Returns the
    spread, the centred value and its recount."""
    import numpy as np
    import torch
    from torchok_tpu_torch.constructor import METRICS
    unit, labels = _unit_rows(state)
    spread = float(1.0 - (unit @ unit.T).min())
    vectors = torch.cat(state["vectors"]).double().cpu()
    centred = (vectors - vectors.mean(0)).float()
    meter = METRICS.get("HitAtKMeter")(**params)
    fresh = meter.empty_state(device)
    for lo in range(0, len(centred), 64):
        fresh = meter.update(fresh, vectors=centred[lo:lo + 64].to(device),
                             group_labels=labels[lo:lo + 64])
    value, recount = meter.compute(fresh), witness_hit(fresh)
    if not abs(value - recount) <= 1e-9:
        fail(f"{label}: HitAtKMeter on the centred embeddings {value} differs from its "
             f"recount {recount}")
    return spread, value, recount


def witness_accuracy(batches):
    """Accuracy (multiclass, micro) recounted in numpy from the (preds,
    target) host batches it was given, its f32 division as the meter's."""
    import numpy as np
    correct = sum(int((np.argmax(p, 1) == t).sum()) for p, t in batches)
    total = sum(len(t) for _, t in batches)
    return float(np.float32(correct) / np.float32(total))


def check_accuracy_planted(label, batches, device):
    """The Accuracy meter (the recipe's, no parameters) over ``batches``,
    the (logits, target) host batches the run gave it, with the targets of a
    seeded half of the rows set to their logits' argmax: a value the run's
    few steps over 11318 classes do not reach (its own reading is 0). The
    meter on the card against :func:`witness_accuracy` to 1e-9. Returns
    both."""
    import numpy as np
    import torch
    from torchok_tpu_torch.constructor import METRICS
    rng = np.random.default_rng(0)
    planted = []
    for logits, target in batches:
        target = target.copy()
        rows = rng.random(len(target)) < 0.5
        target[rows] = np.argmax(logits[rows], 1)
        planted.append((logits, target))
    meter = METRICS.get("Accuracy")()
    state = meter.empty_state(device)
    for logits, target in planted:
        state = meter.update(state, preds=torch.from_numpy(logits).to(device),
                             target=torch.from_numpy(target).to(device))
    value, recount = meter.compute(state), witness_accuracy(planted)
    if not (recount > 0 and abs(value - recount) <= 1e-9):
        fail(f"{label}: Accuracy on planted targets {value} differs from its recount {recount}")
    return value, recount


class ExportTimes:
    """Times every ``export_task_model`` call (the callbacks' and the
    script's) while installed."""

    def __init__(self):
        from torchok_tpu_torch.export import stablehlo
        self.module, self.export, self.seconds = stablehlo, stablehlo.export_task_model, []

    def __enter__(self):
        def timed(*args, **kwargs):
            start = time.perf_counter()
            try:
                return self.export(*args, **kwargs)
            finally:
                self.seconds.append(time.perf_counter() - start)
        self.module.export_task_model = timed
        return self

    def __exit__(self, *exc):
        self.module.export_task_model = self.export


def eval_images(trainer):
    """The VALID set as the eval forward sees it: host and device transforms
    of the trainer, on the card, in order."""
    import torch
    loader = trainer.task.val_dataloader()[0]
    trainer._install_device_fns([loader], train=False)
    loader.worker_processes = False  # one pass: threads start at once
    try:
        return torch.cat([batch["image"] for batch in loader])
    finally:
        loader.close()


def live_forward(task, images, batch=64):
    """The task model's inference forward (``forward_image``, eval mode,
    the task's autocast) over ``images`` in batches of ``batch``."""
    import torch
    module = task.as_module()
    training = module.training
    module.eval()
    try:
        with torch.inference_mode(), torch.autocast(images.device.type, dtype=task.compute_dtype,
                                                    enabled=task.compute_dtype is not None):
            return torch.cat([module.forward_image(images[i:i + batch]).float()
                              for i in range(0, len(images), batch)])
    finally:
        module.train(training)


def replay_artifact(path, images, live):
    """The artifact under ``path`` loaded and run on ``images`` in batches of
    64 and on the first ``REPLAY_SINGLES`` one at a time: each one's largest
    difference from ``live`` over the largest magnitude of ``live``."""
    import torch
    from torchok_tpu_torch.export.stablehlo import StableHLOModel
    runner = StableHLOModel(path)
    scale = live.abs().max().item()
    worst = {}
    for batch, n in ((1, REPLAY_SINGLES), (64, len(images))):
        out = torch.cat([runner(images[i:i + batch]).float() for i in range(0, n, batch)])
        if out.shape != live[:n].shape:
            fail(f"replay of {path}: output {tuple(out.shape)}, live {tuple(live[:n].shape)}")
        worst[batch] = (out - live[:n]).abs().max().item() / scale
    return worst


def check_artifacts(label, trainer, saver, export_missing=False):
    """Every checkpoint ``saver`` left has its artifact beside it (with
    ``export_missing``, for a recipe whose plain ModelCheckpoint exports
    nothing, the script writes it first with ``export_task_model``). Each
    artifact, loaded on the card, replays the VALID images at batch 64 (the
    first ``REPLAY_SINGLES`` also at batch 1) within ``REPLAY_TOLERANCE`` of the largest magnitude of the task's
    own eval forward with that checkpoint's weights. Returns the largest
    difference seen."""
    import glob
    import torch
    from torchok_tpu_torch.export import stablehlo
    model = trainer.state.model
    ckpts = sorted(glob.glob(os.path.join(saver.dirpath, "*.ckpt")))
    if not ckpts:
        fail(f"{label}: no checkpoint in {saver.dirpath}")
    images = eval_images(trainer)
    worst = 0.0
    for ckpt in ckpts:
        artifact = os.path.splitext(ckpt)[0] + ".stablehlo"
        saved = torch.load(ckpt, map_location=images.device, weights_only=True)
        model.load_state_dict(saved["state_dict"])
        if export_missing:
            stablehlo.export_task_model(trainer.task, artifact)
        if not (os.path.isfile(os.path.join(artifact, "model.pt2"))
                and os.path.isfile(os.path.join(artifact, "meta.json"))):
            fail(f"{label}: no artifact beside {os.path.basename(ckpt)} "
                 f"({sorted(os.listdir(saver.dirpath))})")
        errs = replay_artifact(artifact, images, live_forward(trainer.task, images))
        print(f"{label}: {os.path.basename(artifact)} replays {len(images)} VALID images at "
              f"batch 64 within {errs[64]:.3e} and the first {REPLAY_SINGLES} at batch 1 within "
              f"{errs[1]:.3e} of the live eval forward's largest magnitude (tol "
              f"{REPLAY_TOLERANCE:g})", flush=True)
        if not max(errs.values()) <= REPLAY_TOLERANCE:
            fail(f"{label}: {artifact} replays {errs} away from the live eval forward")
        worst = max(worst, *errs.values())
    stray = sorted(p for p in os.listdir(saver.dirpath) if p.endswith(".stablehlo")
                   and os.path.splitext(p)[0] + ".ckpt" not in map(os.path.basename, ckpts))
    if stray:
        fail(f"{label}: artifacts without their checkpoint: {stray}")
    return len(ckpts), worst


def check_frozen_backbone(label, trainer, initial, steps):
    """arcface_sop's epoch-0 policy: the whole backbone frozen. Every frozen
    parameter follows its decay-only SGD trajectory (Nesterov, recomputed
    here; one with no decay stays bit-equal), every BatchNorm statistic of
    the backbone stays bit-equal, every parameter outside it moved."""
    import torch
    state = trainer.state
    model = state.model
    params = dict(model.named_parameters())
    want = {n for n in params if n.startswith("backbone.")}
    if state.frozen_params != want:
        fail(f"{label}: frozen {sorted(state.frozen_params ^ want)[:6]}... differ from the "
             "backbone")
    group_of = {id(p): g for g in trainer.bundles[0].optimizer.param_groups for p in g["params"]}
    worst, decayed, still = 0.0, 0, 0
    for name, p in params.items():
        value, first = p.detach(), initial[name]
        if name not in want:
            if torch.equal(value, first):
                fail(f"{label}: {name} outside the frozen backbone did not move")
            continue
        group = group_of[id(p)]
        if not group["weight_decay"]:
            still += 1
            if not torch.equal(value, first):
                fail(f"{label}: frozen {name} with no decay moved")
            continue
        decayed += 1
        traj = decay_only(first.cpu(), steps, group["lr"], group["weight_decay"],
                          group["momentum"], group["nesterov"])
        err = ((value.cpu().double() - traj).abs() / (traj.abs() + 1e-30)).max().item()
        worst = max(worst, err)
        if not err <= 16 * 2.0 ** -24:
            fail(f"{label}: frozen {name} left its decay-only trajectory ({err:.3e} relative)")
    stats = [k for k in model.state_dict() if k.startswith("backbone.")
             and k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(model.state_dict()[k], initial[k])]
    if not stats or moved:
        fail(f"{label}: backbone BatchNorm statistics that moved: {moved[:6]} (of {len(stats)})")
    print(f"{label} freeze check: {len(want)} backbone tensors frozen, {decayed} on their "
          f"decay-only Nesterov SGD trajectory within {worst:.3e} relative (tol 16 x 2^-24), "
          f"{still} without decay bit-equal, {len(stats)} BatchNorm statistics bit-equal, "
          f"{len(params) - len(want)} tensors outside the backbone moved", flush=True)


def run_sop_recipe(recipe, data_folder):
    """SOP recipe ``recipe`` (``sop_config``: its pipeline, model and
    callbacks at full width, one epoch of ``SOP_LIMIT_TRAIN[recipe]`` steps
    and a validation over the written test split) through ``run(...,
    "train")``. Checks: finite losses; every parameter that trains moved
    (pairwise and triplet: all, with BatchNorm statistics unchanged, as the
    JAX wrapper tasks' inference forward leaves them; arcface:
    :func:`check_frozen_backbone`); HitAtKMeter (:func:`check_hit`) and
    arcface's train Accuracy (also on planted targets:
    :func:`check_accuracy_planted`) equal to numpy recounts to 1e-9; an
    artifact beside every
    checkpoint, each replaying the VALID images (:func:`check_artifacts`).
    resnet18 and semnasnet_100 reach no hand-written kernel, as the JAX ones
    reach no Pallas kernel."""
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.callbacks.model_checkpoint import ModelCheckpoint
    from torchok_tpu_torch.constructor import METRICS
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.ops.common import LAUNCHES

    class Recorder(Callback):
        def on_fit_start(self, trainer, task):
            self.initial = {k: v.detach().clone()
                            for k, v in trainer.state.model.state_dict().items()}

    start = time.perf_counter()
    arcface = recipe == "representation_arcface_sop"
    meter = METRICS.get("HitAtKMeter")
    compute, kept = meter.compute, {}

    def keep_state(self, state):
        kept["state"] = state
        return compute(self, state)

    recorder = Recorder()
    with tempfile.TemporaryDirectory(prefix=f"{recipe}_") as tmp, ExportTimes() as exports:
        cfg, cuts = sop_config(recipe, data_folder, tmp)
        print(f"{recipe}: configs/{recipe}.yaml with the cuts {cuts}", flush=True)
        accuracy, restore = capture_metric_inputs("Accuracy")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.clear()
        meter.compute = keep_state
        try:
            trainer, logs = run(cfg, "train", [recorder])
        finally:
            del meter.compute
            restore()
        torch.cuda.synchronize()
        require_launches(f"{recipe} train", launch_counts(), {})
        peak = torch.cuda.max_memory_allocated()
        stats, evals = trainer.last_fit, trainer.last_eval
        in_fit = len(exports.seconds)
        loss, hit = logs.get("train/loss", float("nan")), logs.get("valid/HitAtKMeter",
                                                                   float("nan"))
        if not (math.isfinite(loss) and math.isfinite(hit)):
            fail(f"{recipe}: train/loss {loss} or valid/HitAtKMeter {hit} not finite")
        if stats["steps"] != SOP_LIMIT_TRAIN[recipe]:
            fail(f"{recipe}: {stats['steps']} train steps, expected {SOP_LIMIT_TRAIN[recipe]}")
        model = trainer.state.model
        if arcface:
            check_frozen_backbone(recipe, trainer, recorder.initial, stats["steps"])
        else:
            state = model.state_dict()
            params = {n for n, _ in model.named_parameters()}
            still = [n for n in params if torch.equal(state[n], recorder.initial[n])]
            moved = [n for n in state if n not in params and n.endswith("running_mean")
                     and not torch.equal(state[n], recorder.initial[n])]
            if still or moved:
                fail(f"{recipe}: parameters that did not move {still[:5]}, BatchNorm "
                     f"statistics that moved {moved[:5]}")
        witness = witness_hit(kept["state"])
        params = next(m["params"] for m in cfg["metrics"] if m["name"] == "HitAtKMeter")
        spread, centred, recount = check_hit(recipe, kept["state"], params,
                                             torch.device("cuda", 0))
        line = (f"{recipe}: valid/HitAtKMeter {hit:.12f}, its numpy recount {witness:.12f} "
                f"(the embeddings' directions spread by {spread:.3e}: "
                + ("held to 1e-9" if spread >= HIT_RESOLVABLE else
                   f"below {HIT_RESOLVABLE:g}, one direction to f32, not held")
                + f"); on them centred {centred:.12f}, its numpy recount {recount:.12f} "
                  "(tol 1e-9)")
        if spread >= HIT_RESOLVABLE and not abs(witness - hit) <= 1e-9:
            fail(f"{recipe}: valid/HitAtKMeter {hit} differs from its recount {witness}")
        if arcface:
            batches = accuracy.get("last", [])
            acc, recount = logs.get("train/Accuracy", float("nan")), witness_accuracy(batches)
            line += f"; train/Accuracy {acc:.12f}, its numpy recount {recount:.12f} (tol 1e-9)"
            if not abs(acc - recount) <= 1e-9:
                fail(f"{recipe}: train/Accuracy {acc} differs from its recount {recount}")
            planted, recount = check_accuracy_planted(recipe, batches, torch.device("cuda", 0))
            line += (f"; Accuracy on the run's {sum(len(t) for _, t in batches)} train logits "
                     f"with half the targets planted at their argmax {planted:.12f}, its numpy "
                     f"recount {recount:.12f} (tol 1e-9)")
        print(line, flush=True)
        saver = next(cb for cb in trainer.callbacks if isinstance(cb, ModelCheckpoint))
        n_ckpts, worst = check_artifacts(recipe, trainer, saver, export_missing=not arcface)
    print(f"{recipe} ({cfg['task']['params']['backbone_name']}, "
          f"{cfg['task']['params']['inputs'][0]['shape']}, bs "
          f"{cfg['data']['TRAIN'][0]['dataloader']['batch_size']}, f32): train/loss={loss:.6f} "
          f"after {stats['steps']} steps; train {stats['images']} images in "
          f"{stats['seconds']:.3f} s = {stats['images'] / stats['seconds']:.2f} img/s, eval "
          f"{evals['images']} images in {evals['seconds']:.3f} s = "
          f"{evals['images'] / evals['seconds']:.2f} img/s (smoke readings: host clock, "
          f"first fetch to the read-back, the recipe's loader worker processes running the "
          f"host pipeline); peak device memory {peak / 2**20:.1f} MiB; {n_ckpts} checkpoints, "
          f"{len(exports.seconds)} exports ({in_fit} in the fit) of "
          f"{', '.join(f'{t:.2f}' for t in exports.seconds)} s; largest replay difference "
          f"{worst:.3e}; 0 hand-written launches; phase {time.perf_counter() - start:.1f} s on "
          f"{card_line()}", flush=True)


def run_sop_recipes():
    """The three SOP recipes at full width (:func:`run_sop_recipe`) on a SOP
    tree the script writes (:func:`write_sop_tree`)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="sop_")
    try:
        start = time.perf_counter()
        written = write_sop_tree(root)
        print(f"SOP tree: {written} PNGs of 200 to 400 px a side ({SOP_CLASSES[0]} train and "
              f"{SOP_CLASSES[1]} test classes of {SOP_PER_CLASS}, {SOP_TRIPLETS} triplets) "
              f"written in {time.perf_counter() - start:.2f} s", flush=True)
        for recipe in SOP_RECIPES:
            stamp(f"{recipe} at full width")
            run_sop_recipe(recipe, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


CIFAR_LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse", "ship",
                "truck"]


def write_cifar_batches(root, images, labels):
    """``<root>/cifar-10-batches-py`` as CIFAR-10's python batches lay it out:
    ``test_batch`` holds ``images`` (N, 32, 32, 3) uint8 and ``labels``,
    ``batches.meta`` the ten names, and the five train batches the first ten
    images each."""
    import pickle
    import numpy as np
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    flat = np.ascontiguousarray(images.transpose(0, 3, 1, 2)).reshape(len(images), -1)
    batches = {"test_batch": (flat, labels)}
    batches.update({f"data_batch_{i}": (flat[:10], labels[:10]) for i in range(1, 6)})
    for name, (data, targets) in batches.items():
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": data, "labels": [int(t) for t in targets]}, f)
    with open(os.path.join(base, "batches.meta"), "wb") as f:
        pickle.dump({"label_names": CIFAR_LABELS}, f)


def run_stablehlo_infer(shapes_state):
    """``configs/stablehlo_infer.yaml`` through ``ONNXTask`` on the card: the
    classification north star's trained resnet18 (``shapes_state``, its
    best checkpoint) is tested live with the recipe's TEST data and metrics
    on the shapes VALID images written as a CIFAR-10 test batch, exported
    with ``export_task_model``, and the recipe replays the artifact with
    ``+mode=test``. Its Accuracy and F1Score must equal the live test's to
    1e-9. 0 hand-written launches."""
    import tempfile
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.constructor import DATASETS
    from torchok_tpu_torch.data.datasets.examples.cifar import CIFAR10
    from torchok_tpu_torch.export.stablehlo import export_task_model
    from torchok_tpu_torch.ops.common import LAUNCHES

    start = time.perf_counter()
    valid = SHAPES_RECIPE["data"]["VALID"][0]["dataset"]["params"]
    shapes = DATASETS.get("SyntheticShapesDataset")(None, **valid)
    integrity = (CIFAR10.train_list, CIFAR10.test_list, CIFAR10.meta)
    with tempfile.TemporaryDirectory(prefix="stablehlo_infer_") as tmp:
        folder = os.path.join(tmp, "cifar10")
        write_cifar_batches(folder, shapes.images, shapes.targets)
        ckpt = os.path.join(tmp, "shapes.ckpt")
        torch.save({"state_dict": shapes_state}, ckpt)
        cfg, cuts = stablehlo_infer_config(os.path.join(tmp, "shapes.stablehlo"), folder,
                                           os.path.join(tmp, "infer"))
        print(f"stablehlo_infer: configs/stablehlo_infer.yaml with the cuts {cuts}", flush=True)
        live_cfg = shapes_config(os.path.join(tmp, "live"))
        live_cfg.update(data={"TEST": copy.deepcopy(cfg["data"]["TEST"])},
                        metrics=copy.deepcopy(cfg["metrics"]), resume_path=ckpt)
        CIFAR10.train_list = [[name, None] for name, _ in integrity[0]]
        CIFAR10.test_list = [[name, None] for name, _ in integrity[1]]
        CIFAR10.meta = {**integrity[2], "md5": None}
        try:
            LAUNCHES.clear()
            trainer, live = run(live_cfg, "test")
            export_start = time.perf_counter()
            export_task_model(trainer.task, cfg["task"]["params"]["path_to_onnx"])
            exported = time.perf_counter() - export_start
            _, replayed = run(cfg, "test")
            torch.cuda.synchronize()
            require_launches("stablehlo_infer", launch_counts(), {})
        finally:
            CIFAR10.train_list, CIFAR10.test_list, CIFAR10.meta = integrity
    print(f"stablehlo_infer (the shapes north star's resnet18 at 32x32, bf16 autocast, "
          f"{len(shapes.images)} images as a CIFAR-10 test batch): ONNXTask test {replayed}, "
          f"the live task's test {live}; export {exported:.2f} s; phase "
          f"{time.perf_counter() - start:.1f} s on {card_line()}", flush=True)
    for key in ("test/Accuracy", "test/F1Score"):
        a, b = replayed.get(key, float("nan")), live.get(key, float("nan"))
        if not (math.isfinite(a) and abs(a - b) <= 1e-9):
            fail(f"stablehlo_infer: {key} {a} through ONNXTask, {b} from the live task")


def check_kernel_export_refused():
    """``export_task_model`` on the swinv2_tiny slice's task (its eval
    forward launches K1) must raise ``NotImplementedError`` naming K1 and
    write no program."""
    import tempfile
    from torchok_tpu_torch.constructor import TASKS
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import merge_structured
    from torchok_tpu_torch.export.stablehlo import export_task_model

    config = merge_structured(config_from_dict(copy.deepcopy(SLICE_CONFIG)))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    task.model.cuda()
    with tempfile.TemporaryDirectory(prefix="swin_export_") as tmp:
        path = os.path.join(tmp, "swin.stablehlo")
        try:
            export_task_model(task, path)
        except NotImplementedError as e:
            message = str(e)
        else:
            fail("export of swinv2_tiny (K1 in its eval forward) did not raise")
        if "K1" not in message or os.path.exists(os.path.join(path, "model.pt2")):
            fail(f"export of swinv2_tiny raised without naming K1 or left a program: {message}")
    print(f"export refused for swinv2_tiny_window8_256: NotImplementedError({message!r})",
          flush=True)


# ``chip_smoke.py --side-phases``: the phases the full run starts in a
# process of their own once the kernel timings are done. They read and
# augment files and export models, so they use the host's cores and little
# of the card, and they end before the main process's later phases do
SIDE_PHASES = (("spatial", run_spatial_recipe), ("photometric", run_photometric_recipe),
               ("sweet_pepper", run_augment_recipe), ("sop", run_sop_recipes))


def start_side_phases(log_dir):
    """``chip_smoke.py --side-phases`` started by :func:`start_processes`,
    on two intra-op threads for its CPU work (export tracing, the CPU parts
    of its steps): the host's 8 cores also serve the DETR draws and this
    process."""
    return start_processes([("side phases", ["--side-phases"], {"OMP_NUM_THREADS": "2"})],
                           log_dir)


def side_phases_main() -> None:
    """``chip_smoke.py --side-phases``: ``SIDE_PHASES`` in order, on one
    card, with this script's checks; the first failed check exits 1."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: these phases need an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{card_line()}; torch {torch.__version__}", flush=True)
    for name, phase in SIDE_PHASES:
        stamp(name)
        phase()
    stamp("side phases done")


def main() -> None:
    script_start = _START
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "torchok_tpu_torch", "csrc")):
        fail(f"torchok_tpu_torch is not beside {__file__}: run it from a checkout")
    sys.path.insert(0, repo)
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the FCOS and DETR recipes' toy set; the five DETR draws take longest of
    # all (host-bound, side by side), so they run in processes of their own
    # from here on, beside the build, the kernel checks and every later phase
    import shutil
    import tempfile
    toy_root = tempfile.mkdtemp(prefix="toydet_")
    atexit.register(shutil.rmtree, toy_root, ignore_errors=True)
    images, written = ensure_toy_detection(toy_root)
    print(f"toy detection set: {images} PNGs written in {written:.2f} s", flush=True)
    stamp(f"detr recipe, draws {list(DETR_DRAWS)} and the determinism check started in "
          f"processes of their own")
    detr_recipe = start_detr_recipe(toy_root)

    from torchok_tpu_torch.ops import conv_bn, conv_gemm, mbconv_fused
    from torchok_tpu_torch.ops import swin_attention as swin
    from torchok_tpu_torch.ops import window_attention as wa
    from torchok_tpu_torch.ops import window_attention_dot as dot
    from torchok_tpu_torch.utils.cuda_build import build_log, load_libraries
    kernels = (swin.KERNEL, swin.KERNEL_BWD) + dot.KERNELS + (wa.KERNEL, conv_bn.KERNEL,
                                                              conv_gemm.KERNEL,
                                                              mbconv_fused.KERNEL)
    start = time.perf_counter()
    load_libraries(kernels)
    print(f"built {', '.join(kernels)} side by side in {time.perf_counter() - start:.2f} s",
          flush=True)
    for kernel in kernels:
        # registers, shared memory and spills of each instantiation
        print("\n".join(ln for ln in build_log(kernel).splitlines()
                        if not ln.startswith("ptxas info    : Compiling")
                        and "Function properties" not in ln), flush=True)

    for kind, kernel in (("K7", conv_bn.KERNEL), ("K8", conv_gemm.KERNEL)):
        has_hgmma = sass_has_hgmma(kernel)
        print(f"{kind} SASS has HGMMA: {str(has_hgmma).lower()}", flush=True)
        if not has_hgmma:
            fail(f"the bf16 route of {kernel} was not compiled to wgmma (no HGMMA in its SASS)")

    # K1: swin_fwd_kernel<tile rows / 16, images a block>; K2: its two passes,
    # masked and unmasked
    check_mma_build("K1", swin.KERNEL, "swin_fwd_kernel", swin.forward_route)
    # the tensor-core backward's passes: bwd_{dq,dkdv}_kernel<kCosine, kShifted,
    # kHasBias, kGlobal>, K2 masked and unmasked, K3b with and without a bias, K5
    check_mma_build("K2", swin.KERNEL_BWD, "bwd_d", swin.backward_route)
    dot_windows = sorted({st[4] for st in GCVIT_STAGES + DAVIT_STAGES})
    for kind, kernel, count in (("K3b", dot.KERNEL_BWD, 4), ("K5", dot.KERNEL_GLOBAL_BWD, 2)):
        check_mma_build(kind, kernel, "bwd_d",
                        lambda dtype, ws, k=kernel: dot.backward_route(k, dtype), count,
                        dot_windows)
    # the tensor-core forward's plain modes: swin_fwd_kernel<tile rows / 16,
    # images, kCosine false, kHasBias, kGlobal>, K3a with and without a bias,
    # K4 above L = 64, and K4's window walk global_fwd_kernel<tile rows / 16>
    for kind, kernel in (("K3a", dot.KERNEL), ("K4", dot.KERNEL_GLOBAL)):
        check_mma_build(kind, kernel, PLAIN_FWD_MMA,
                        lambda dtype, ws, k=kernel: dot.forward_route(k, dtype), 4, dot_windows)
    # K9's cluster kernels (k = 1, 3, 5, 7); K6's mw_fwd_kernel<L, kHasMask>
    check_hmma("K9 cluster", mbconv_fused.KERNEL, "mbconv_cluster_kernel")
    check_hmma("K6", wa.KERNEL, MW_MMA)
    stamp("kernel checks")
    k1, k2 = check_k1(), check_k2()
    k3a, k3b = check_k3()
    k4, k5 = check_k4(), check_k5()
    k6, k7, k8 = check_k6(), check_k7(), check_k8()
    mbconv_probe = load_tool("probe_torch_mbconv_fused")
    b0 = b0_cases(mbconv_probe, torch.device("cuda", 0))
    k9 = check_k9(mbconv_probe, b0)
    all_records = (k1, k2, k3a, k3b, k4, k5, k6, k7, k8, k9)
    records = {r["name"]: r for r in all_records}
    stamp("op paths")
    run_op_paths(records)
    run_mbconv_path(mbconv_probe, b0, records)
    del b0
    stamp("side phases started in a process of their own")
    side_phases = start_side_phases(toy_root)

    stamp("swinv2 slices")
    swin_fwd, swin_bwd = {swin.KERNEL: 12}, {swin.KERNEL_BWD: 12}
    run_slice("swinv2_tiny", SLICE_CONFIG, swin_fwd, records, 256)
    run_train_slice("swinv2_tiny", TRAIN_CONFIG, 256, swin_fwd, swin_bwd,
                    ("qkv", "cpb_mlp", "logit_scale"), records)
    gradient_reference("swinv2_tiny", TRAIN_CONFIG, 256, {**swin_fwd, **swin_bwd}, "cpb_mlp")
    # window 16: 10 blocks at L = 256 and 2 at L = 64 per forward
    run_slice("swinv2_tiny_window16", WINDOW16_SLICE_CONFIG, swin_fwd, records, 256)
    run_train_slice("swinv2_tiny_window16", WINDOW16_TRAIN_CONFIG, 256, swin_fwd, swin_bwd,
                    ("qkv", "cpb_mlp", "logit_scale"), records)
    gradient_reference("swinv2_tiny_window16", WINDOW16_TRAIN_CONFIG, 256,
                       {**swin_fwd, **swin_bwd}, "cpb_mlp")
    # window 24 at 384: 22 blocks at L = 576 and 2 at L = 144
    run_slice("swinv2_base_window12to24_384", BASE384_SLICE_CONFIG, {swin.KERNEL: 24}, records,
              384)
    run_swinv2_variants(records)

    stamp("gcvit and davit slices")
    gcvit_fwd = {dot.KERNEL: GCVIT_LOCAL, dot.KERNEL_GLOBAL: GCVIT_GLOBAL}
    gcvit_bwd = {dot.KERNEL_BWD: GCVIT_LOCAL, dot.KERNEL_GLOBAL_BWD: GCVIT_GLOBAL}
    # bf16 autocast: every K3a and K4 launch on the tensor cores
    gcvit_fwd_routes = {(dot.KERNEL, "mma"): GCVIT_LOCAL, (dot.KERNEL_GLOBAL, "mma"): GCVIT_GLOBAL}
    run_slice("gcvit_tiny", GCVIT_SLICE_CONFIG, gcvit_fwd, records, 224,
              fwd_routes=gcvit_fwd_routes)
    # stages.0.blocks.1 is a global block: its qkv emits k and v only
    run_train_slice("gcvit_tiny", GCVIT_TRAIN_CONFIG, 224, gcvit_fwd, gcvit_bwd,
                    ("relative_position_bias_table", "stages.0.blocks.1.attn.qkv",
                     "global_block"), records,
                    {(dot.KERNEL_BWD, "mma"): GCVIT_LOCAL,
                     (dot.KERNEL_GLOBAL_BWD, "mma"): GCVIT_GLOBAL}, gcvit_fwd_routes)
    gradient_reference("gcvit_tiny", GCVIT_TRAIN_CONFIG, 224, {**gcvit_fwd, **gcvit_bwd},
                       "relative_position_bias_table")
    run_train_slice("davit_t", DAVIT_TRAIN_CONFIG, 224, {dot.KERNEL: DAVIT_SPATIAL},
                    {dot.KERNEL_BWD: DAVIT_SPATIAL}, ("main_blocks.0.0.0.attn.qkv",), records,
                    {(dot.KERNEL_BWD, "mma"): DAVIT_SPATIAL}, {(dot.KERNEL, "mma"): DAVIT_SPATIAL})

    # the JAX ResNet reaches no Pallas kernel, so the port's reaches none of
    # the hand-written kernels: every counter stays at 0 through these runs
    stamp("resnet50, efficientnet_b0, mobilenetv3 slices")
    run_slice("resnet50", RESNET_SLICE_CONFIG, {}, records, 224, unzero_last_norms)
    run_train_slice("resnet50", RESNET_TRAIN_CONFIG, 224, {}, {},
                    ("layer1.0.conv1.weight", "layer4.2.bn3.weight", "layer3.5.bn2.running_var",
                     "head"), records)
    print("resnet50: 0 launches of every hand-written kernel in test, predict and train, as "
          "the JAX ResNet calls no Pallas kernel either (K7 and K8 are reached through "
          "their ops above)", flush=True)

    # the JAX EfficientNet and MobileNetV3 reach no Pallas kernel either (K9 is
    # reached through its op above): every counter stays at 0
    run_slice("efficientnet_b0", EFFNET_SLICE_CONFIG, {}, records, 224, calibrate_norms)
    run_train_slice("efficientnet_b0", EFFNET_TRAIN_CONFIG, 224, {}, {},
                    ("conv_stem.weight", "blocks.5.3.se.fc1.weight", "blocks.6.0.bn3.running_var",
                     "head"), records)
    run_slice("mobilenetv3_large_100", MNV3_SLICE_CONFIG, {}, records, 224, calibrate_norms)
    print("efficientnet_b0 (test, predict, train) and mobilenetv3_large_100 (test): 0 launches "
          "of every hand-written kernel", flush=True)

    # bench.py's hrnet_w18_224_bs128: HRNet-W18 with HRNetClassificationNeck;
    # the JAX HRNet and neck reach no Pallas kernel, so every counter stays at 0
    stamp("hrnet_w18 slices")
    run_slice("hrnet_w18", HRNET_SLICE_CONFIG, {}, records, 224, unzero_and_calibrate)
    run_train_slice("hrnet_w18", HRNET_TRAIN_CONFIG, 224, {}, {},
                    ("backbone.stage4.2.fuse_layers.0.1.0.weight",
                     "backbone.transition3.3.0.0.weight", "neck.final.conv.weight", "head"),
                    records)
    gradient_reference("hrnet_w18", HRNET_TRAIN_CONFIG, 224, {}, "neck.final.conv",
                       drop_path=False, dtype="float64")
    print("hrnet_w18 (test, predict, train, gradient reference): 0 launches of every "
          "hand-written kernel", flush=True)

    # bench.py's vit_small_224_bs128 and beit_base_224_bs128: global attention
    # on SDPA, as the JAX ViT and BEiT leave it to XLA; every counter stays at 0
    stamp("vit and beit slices")
    run_vit_beit_slices(records)

    stamp("north stars")
    shapes_state = run_shapes_recipe()
    stamp("stablehlo_infer: the shapes model exported and replayed through ONNXTask")
    run_stablehlo_infer(shapes_state)
    check_kernel_export_refused()
    run_resume_phase(records)
    check_knn_index()
    run_arcface_recipe()
    run_segmentation_recipe()
    run_fcos_recipe(toy_root)
    run_fcos_full_width()
    stamp("fcos_vit at full width, under FreezeUnfreeze")
    run_fcos_vit_full_width()
    stamp("detr_gcvit at full width")
    run_detr_full_width(records)
    stamp("side phases, joined")
    failures, texts = wait_processes(side_phases)
    if failures:
        fail("side phases: " + "; ".join(failures))
    # the side recipes' launches, counted in the side process: K1 and K2 of
    # the spatial recipe, K3a, K3b, K4 and K5 of the photometric one
    side = side_launches(texts["side phases"])
    for phase, kernels in (("spatial", (swin.KERNEL, swin.KERNEL_BWD)),
                           ("photometric", dot.KERNELS)):
        if not all(side.get(phase, {}).get(k) for k in kernels):
            fail(f"side phases: the {phase} recipe reported no launches of {kernels}: "
                 f"{side.get(phase)}")
    for counts in side.values():
        for kernel, count in counts.items():
            records[kernel]["launches"] += count
    stamp("detr recipe, joined")
    finish_detr_recipe(detr_recipe)

    print(json.dumps({"kernels": list(all_records)}), flush=True)
    print(f"chip_smoke total: {time.perf_counter() - script_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def detr_recipe_main(argv) -> None:
    """``chip_smoke.py --detr-recipe TOY_ROOT [--seed N]``: the DETR north
    star alone (:func:`run_detr_recipe`); ``chip_smoke.py --detr-determinism
    TOY_ROOT``: :func:`check_detr_determinism`. :func:`start_detr_recipe`
    and ``tools/detr_seed_spread.py`` start them so."""
    import argparse
    import torch
    mode, argv = argv[0], argv[1:]
    parser = argparse.ArgumentParser(prog=f"chip_smoke.py {mode}")
    parser.add_argument("toy_root")
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "--detr-determinism":
        check_detr_determinism(args.toy_root)
    else:
        run_detr_recipe(args.toy_root, args.seed)


if __name__ == "__main__":
    # the FCOS north star and the DETR draws run under trainer.deterministic,
    # and cuBLAS reads its workspace setting at the process's first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if sys.argv[1:2] in (["--detr-recipe"], ["--detr-determinism"]):
        detr_recipe_main(sys.argv[1:])
    elif sys.argv[1:] == ["--side-phases"]:
        side_phases_main()
    else:
        main()

"""Which ops of the toy DETR train step have no deterministic CUDA kernel,
and does ``trainer.deterministic=true`` make the step reproducible?

    python tools/probe_detr_determinism.py [--steps 20]

On one card: writes the toy detection set, runs the DETR recipe's first
``--steps`` train steps once under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and prints every distinct warning PyTorch gives for an op
with no deterministic kernel (each would raise under the trainer's mode),
then runs ``chip_smoke.check_detr_determinism`` (twice with the trainer's
mode, twice without, parameters compared bit for bit).
"""
import argparse
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path

# before the first cuBLAS call of the process
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=chip_smoke.DETR_DETERMINISM_STEPS)
    args = parser.parse_args()
    import torch
    from torchok_tpu_torch.__main__ import run
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="toydet_") as toy_root:
        images, written = chip_smoke.ensure_toy_detection(toy_root)
        print(f"toy detection set: {images} PNGs written in {written:.2f} s", flush=True)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                run(chip_smoke.detr_steps_config(toy_root, args.steps, False), "train")
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        found = sorted({str(w.message) for w in caught if "determinis" in str(w.message)})
        print(f"warn_only run of {args.steps} steps in {time.perf_counter() - t0:.2f} s: "
              f"{len(found)} distinct warnings about determinism", flush=True)
        for message in found:
            print(f"  - {message}", flush=True)
        chip_smoke.check_detr_determinism(toy_root, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The spread of the DETR north star over initial draws: runs
``configs/detection_toy_detr.yaml`` at its short budget from the port's own
initial weights for each seed given, with ``chip_smoke.DETR_PHASE_OVERRIDES``
(``trainer.deterministic=true``), each in a process of its own, side by side
on one card, beside ``chip_smoke.check_detr_determinism`` (as
``chip_smoke.start_detr_recipe`` starts them), and prints each seed's
valid/map50 with the recipe's decoding (10 boxes an image) and with the
reference's (all 64 queries), their mean and the gate's floor.

    python tools/detr_seed_spread.py --seeds 0 1 2 3 7 --out build/detr_seeds

Each run's whole output goes to ``OUT/detr_seed_<N>.log``. The runs share
the host's cores and the card, so their img/s readings are not the recipe's.
Exits 0 when every run passed its own checks, whether or not the mean passed.
"""
import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default="build/detr_seeds")
    parser.add_argument("--timeout", type=float, default=1500.0)
    args = parser.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="toydet_") as toy_root:
        images, written = chip_smoke.ensure_toy_detection(toy_root)
        print(f"toy detection set: {images} PNGs written in {written:.2f} s", flush=True)
        start = time.perf_counter()
        runs = chip_smoke.start_detr_recipe(toy_root, args.seeds, str(out))
        failures, readings = chip_smoke.wait_detr_recipe(
            runs, args.timeout + start - chip_smoke._START)
        seconds = time.perf_counter() - start
    floor = chip_smoke.DETR_REFERENCE - chip_smoke.DETR_TOLERANCE
    for seed in args.seeds:
        if seed in readings:
            reference, recipe = readings[seed]
            print(f"seed {seed}: valid/map50 {reference:.6f} with the reference's decoding (64 "
                  f"boxes an image), {recipe:.6f} with the recipe's (10 boxes)", flush=True)
    if readings:
        mean = statistics.fmean(r[0] for r in readings.values())
        print(f"mean over {sorted(readings)} with the reference's decoding {mean:.6f} (floor "
              f"{floor:.4f}: {'pass' if mean >= floor else 'below'})", flush=True)
    print(f"{len(runs)} processes side by side in {seconds:.1f} s; failures: {failures}",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""The spread of the DETR north star over initial draws: runs
``configs/detection_toy_detr.yaml`` at its short budget from the port's own
initial weights for each seed given (``chip_smoke.py --detr-recipe TOY_ROOT
--seed N``), each in a process of its own, side by side on one card, and
prints each seed's valid/map50 with the recipe's decoding (10 boxes an image)
and with the reference's (all 64 queries), beside the gate's floor.

    python tools/detr_seed_spread.py --seeds 0 1 2 3 --out build/detr_seeds

Each run's whole output goes to ``OUT/seed_<N>.log``. The runs share the
host's cores and the card, so their img/s readings are not the recipe's.
Exits 0 when every run printed both readings, whether or not it passed.
"""
import argparse
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

RECIPE = re.compile(r"valid/map50=([0-9.]+) at global_step (\d+) with the recipe's decoding")
REFERENCE = re.compile(r"the gate's reading.*?valid/map50=([0-9.]+)")


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
        runs = {}
        for seed in args.seeds:
            log = open(out / f"seed_{seed}.log", "w")
            runs[seed] = (subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--detr-recipe", toy_root,
                 "--seed", str(seed)], stdout=log, stderr=subprocess.STDOUT, cwd=REPO), log)
        complete = True
        for seed, (proc, log) in runs.items():
            try:
                rc = proc.wait(timeout=max(1.0, args.timeout - (time.perf_counter() - start)))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.close()
            text = (out / f"seed_{seed}.log").read_text()
            recipe, reference = RECIPE.search(text), REFERENCE.search(text)
            if not (recipe and reference):
                complete = False
                print(f"seed {seed}: exit code {rc}, no reading; the end of its log:\n"
                      f"{text[-2000:]}", flush=True)
                continue
            floor = chip_smoke.DETR_REFERENCE - chip_smoke.DETR_TOLERANCE
            print(f"seed {seed}: valid/map50 {float(reference[1]):.6f} with the reference's "
                  f"decoding (64 boxes an image; floor {floor:.4f}: "
                  f"{'pass' if float(reference[1]) >= floor else 'below'}), "
                  f"{float(recipe[1]):.6f} with the recipe's (10 boxes), at global_step "
                  f"{recipe[2]}; exit code {rc}", flush=True)
        print(f"{len(runs)} runs side by side in {time.perf_counter() - start:.1f} s",
              flush=True)
    return 0 if complete else 1


if __name__ == "__main__":
    sys.exit(main())

"""Worker threads against worker processes for the port's DataLoader on the
CPU, on the toy detection set (``chip_smoke.write_toy_detection``):

1. the loader alone: one pass over the TRAIN split of
   ``configs/detection_toy_detr.yaml`` (bs 32, 4 workers, PNG decode,
   HorizontalFlip, Normalize), the seconds to the first batch and to the end;
2. a short fit of that recipe on the CPU (``trainer.accelerator=cpu``, one
   epoch, so ``--train`` / 128 executions of 4 steps), the loader set to
   each kind in turn: the epoch's seconds as the trainer counts them and the
   whole call's.

    python tools/bench_loader_workers.py --train 512 --repeats 2

Each kind runs ``--repeats`` times, alternating. The host's clock; no card
is used.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def loader_pass(config, processes):
    from torchok_tpu_torch.constructor.config import config_from_dict
    from torchok_tpu_torch.constructor.config_structure import Phase
    from torchok_tpu_torch.constructor.constructor import Constructor
    loader = Constructor(config_from_dict(config)).create_dataloaders(Phase.TRAIN)[0]
    loader.worker_processes = processes
    start = time.perf_counter()
    first = None
    batches = 0
    try:
        for _ in loader:
            batches += 1
            if first is None:
                first = time.perf_counter() - start
    finally:
        loader.close()
    return first, time.perf_counter() - start, batches


def fit(config, processes):
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.trainer import Trainer
    install = Trainer._install_device_fns

    def forced(self, loaders, train):
        install(self, loaders, train)
        for ld in loaders:
            ld.worker_processes = processes
    Trainer._install_device_fns = forced
    start = time.perf_counter()
    try:
        trainer, _ = run(config, "train")
    finally:
        Trainer._install_device_fns = install
    return trainer.last_fit["seconds"], time.perf_counter() - start, trainer.last_fit["steps"]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train", type=int, default=512)
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    import torch
    print(f"{os.cpu_count()} cores, torch {torch.__version__} on {torch.get_num_threads()} "
          f"threads", flush=True)
    with tempfile.TemporaryDirectory(prefix="loader_bench_") as root:
        for split, n, seed in (("train", args.train, 1), ("valid", 64, 2)):
            chip_smoke.write_toy_detection(os.path.join(root, split), split, n, seed)
        config = chip_smoke.detr_config(root, os.path.join(root, "logs"))
        config["trainer"].update(accelerator="cpu", max_epochs=1, check_val_every_n_epoch=1)
        config["callbacks"] = [c for c in config["callbacks"] if c["name"] != "ModelCheckpoint"]
        for rep in range(args.repeats):
            for processes in (False, True):
                kind = "processes" if processes else "threads"
                first, total, batches = loader_pass(config, processes)
                print(f"loader alone, {kind}: first batch {first:.3f} s, {batches} batches in "
                      f"{total:.3f} s (repeat {rep})", flush=True)
        for rep in range(args.repeats):
            for processes in (False, True):
                kind = "processes" if processes else "threads"
                epoch, total, steps = fit(config, processes)
                print(f"CPU fit, {kind}: {steps} steps in {epoch:.3f} s as the trainer counts "
                      f"them, {total:.3f} s for the whole call (repeat {rep})", flush=True)


if __name__ == "__main__":
    main()

"""valid/map50 after each epoch of the FCOS north star's short budget
(``configs/detection_toy_fcos.yaml``, 8 epochs) on the CPU, in the JAX
package or in the port, for each seed given: whether the one-epoch dips the
port shows on the card are the recipe's or the port's.

    python tools/fcos_trajectories_cpu.py --package jax --seeds 7 0
    python tools/fcos_trajectories_cpu.py --package torch --seeds 7 0

The toy set is written under ``--data`` as ``chip_smoke.write_toy_detection``
writes it (the set of ``tools/gen_toy_detection.py``); logs go to a
temporary folder. Both packages are deterministic on the CPU, so a seed gives
one trajectory; their weights start from different draws, so the two
packages' trajectories compare as distributions, not epoch by epoch. One run
takes several minutes on a few cores.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def jax_run(data: str, logs: str, seed: int) -> list:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from torchok_tpu.constructor import TASKS
    from torchok_tpu.constructor.config import load_config
    from torchok_tpu.constructor.config_structure import merge_structured
    from torchok_tpu.constructor.runner import create_trainer
    from torchok_tpu.engine.callbacks import Callback
    from torchok_tpu.utils.seed import seed_everything

    overrides = [*chip_smoke.FCOS_OVERRIDES, f"seed_params.seed={seed}",
                 f"logger.log_dir={logs}"]
    overrides += [f"data.{phase}.0.dataset.params.data_folder={data}/{split}"
                  for phase, split in (("TRAIN", "train"), ("VALID", "valid"))]
    config = merge_structured(load_config(str(REPO / "configs"), "detection_toy_fcos", overrides))
    seed_everything(seed)
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    trainer = create_trainer(config)
    readings = []

    class Reader(Callback):
        def on_validation_epoch_end(self, trainer, task, logs):
            readings.append(float(logs["valid/map50"]))

    trainer.callbacks.append(Reader())
    trainer.fit(task)
    return readings


def torch_run(data: str, logs: str, seed: int) -> list:
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback

    readings = []

    class Reader(Callback):
        def on_validation_epoch_end(self, trainer, task, logs):
            readings.append(float(logs["valid/map50"]))

    cfg = chip_smoke.fcos_config(data, logs)
    cfg["seed_params"]["seed"] = seed
    cfg["trainer"]["accelerator"] = "cpu"
    run(cfg, "train", [Reader()])
    return readings


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", choices=("jax", "torch"), required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[7])
    parser.add_argument("--data", default="build/toydet")
    args = parser.parse_args()
    chip_smoke.ensure_toy_detection(args.data)
    for seed in args.seeds:
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="fcos_logs_") as logs:
            readings = (jax_run if args.package == "jax" else torch_run)(args.data, logs, seed)
        print(json.dumps({"package": args.package, "seed": seed,
                          "map50_by_epoch": [round(v, 6) for v in readings],
                          "seconds": round(time.perf_counter() - start, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

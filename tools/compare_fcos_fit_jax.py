"""The FCOS north star's first epoch in the JAX package and in the port on
the CPU from the same initial weights over the same batches: each train
step's loss side by side, and valid/map50 after the epoch.

    python tools/compare_fcos_fit_jax.py --seed 6 --steps 62 --data build/toydet

The recipe (``chip_smoke.fcos_config``: resnet18 + FPN + FCOSHead at 96x96,
bs 32, f32, SGD lr 0.01 with momentum 0.9) with three changes, so that both
packages see the same batches: the train loader does not shuffle, the host
HorizontalFlip is left out, and the epoch stops after ``--steps`` steps. The
JAX package draws the initial weights from ``--seed``; the port starts from
them through ``utils/flax_convert``. Two f32 fits part by rounding from the
first step on; a parting that grows smoothly from there is that rounding
amplified by the training, one that jumps at a step is a difference of the
two packages at that step.
"""
import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def fit_config(data: str, seed: int, steps: int) -> dict:
    cfg = chip_smoke.fcos_config(data, "")
    cfg["seed_params"]["seed"] = seed
    train = cfg["data"]["TRAIN"][0]
    train["dataloader"]["shuffle"] = False
    train["dataset"].pop("augment")
    cfg["trainer"].update(accelerator="cpu", max_epochs=1, limit_train_batches=steps,
                          log_every_n_steps=1)
    for key in ("logger", "callbacks"):
        del cfg[key]
    return cfg


def jax_fit(cfg: dict):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from torchok_tpu.constructor import TASKS
    from torchok_tpu.constructor.config import ConfigNode
    from torchok_tpu.constructor.config_structure import merge_structured
    from torchok_tpu.constructor.runner import create_trainer
    from torchok_tpu.engine.callbacks import Callback
    from torchok_tpu.utils.seed import seed_everything

    losses, initial = [], {}

    class Losses(Callback):
        def on_train_batch_end(self, trainer, task, step, logs):
            losses.append({k: float(v) for k, v in logs.items()})

    config = merge_structured(ConfigNode(copy.deepcopy(cfg)))
    seed_everything(cfg["seed_params"]["seed"])
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    trainer = create_trainer(config)
    trainer.callbacks.append(Losses())
    setup = trainer._setup_state

    def setup_and_keep(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update(jax.device_get({"params": trainer.state.params,
                                       "batch_stats": trainer.state.batch_stats}))

    trainer._setup_state = setup_and_keep
    trainer.fit(task)
    return initial, losses, float(trainer.callback_metrics["valid/map50"])


def port_fit(cfg: dict, initial: dict):
    import numpy as np
    import torch
    from torchok_tpu_torch.__main__ import run
    from torchok_tpu_torch.engine.callbacks import Callback
    from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict

    losses = []

    class Losses(Callback):
        def on_train_batch_end(self, trainer, task, step, logs):
            losses.append(dict(logs))

    state = task_flax_to_state_dict(cfg["task"]["params"]["backbone_name"], initial)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "initial.pt"
        torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}},
                   ckpt)
        _, logs = run({**copy.deepcopy(cfg), "resume_path": str(ckpt)}, "train", [Losses()])
    return losses, float(logs["valid/map50"])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--steps", type=int, default=62)
    parser.add_argument("--data", default="build/toydet")
    args = parser.parse_args()
    chip_smoke.ensure_toy_detection(args.data)
    cfg = fit_config(args.data, args.seed, args.steps)
    initial, ref, ref_map = jax_fit(cfg)
    got, got_map = port_fit(cfg, initial)
    for step, (a, b) in enumerate(zip(ref, got), 1):
        print(json.dumps({"step": step, **{f"jax_{k}": round(v, 7) for k, v in a.items()},
                          **{f"port_{k}": round(v, 7) for k, v in b.items()},
                          "relative": abs(a["loss"] - b["loss"]) / abs(a["loss"])}), flush=True)
    print(json.dumps({"seed": args.seed, "steps": len(ref), "jax_map50": ref_map,
                      "port_map50": got_map}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

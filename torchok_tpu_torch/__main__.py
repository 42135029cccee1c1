"""CLI entrypoint (reference: torchok/__main__.py:13-55).

Usage, as for ``torchok_tpu``:
    python -m torchok_tpu_torch -cp <config_dir> -cn <config_name> [+mode=train] [a.b=c ...]

``entrypoint`` is ``load_config`` (YAML + overrides) followed by
``run(config, mode)``; ``run`` also takes a plain dict, which needs no
pyyaml.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torchok_tpu_torch  # noqa: F401 — registers all components
from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode, config_from_dict, load_config
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.constructor.runner import create_trainer
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.trainer import Trainer
from torchok_tpu_torch.utils.seed import seed_everything

MODES = ("train", "test", "predict")


class EpochPrinter(Callback):
    """One summary line per epoch, as ``torchok_tpu``'s progress callback
    prints it: ``epoch N | 1.2s | train/loss=... | valid/Accuracy=...``."""

    def __init__(self):
        self._t0: Optional[float] = None

    def on_train_epoch_start(self, trainer, task) -> None:
        self._t0 = time.perf_counter()

    def on_epoch_end(self, trainer, task, logs: Dict[str, float]) -> None:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        parts = [f"epoch {trainer.current_epoch}", f"{dt:.1f}s"]
        for k, v in sorted(logs.items()):
            if isinstance(v, (int, float)) and not k.endswith("epoch_time_s"):
                parts.append(f"{k}={v:.4f}")
        print(" | ".join(parts), flush=True)


def parse_args(argv):
    parser = argparse.ArgumentParser(prog="torchok_tpu_torch")
    parser.add_argument("-cp", "--config-path", required=True,
                        help="directory containing the config")
    parser.add_argument("-cn", "--config-name", required=True,
                        help="config file name (without .yaml)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted overrides, e.g. trainer.limit_test_batches=3 +mode=test")
    return parser.parse_args(argv)


def extract_mode(overrides):
    mode = "train"
    rest = []
    for ov in overrides:
        key, _, value = ov.partition("=")
        if key in ("mode", "+mode"):
            mode = value
        else:
            rest.append(ov)
    return mode, rest


def run(config: Union[ConfigNode, Mapping[str, Any]], mode: str,
        callbacks: Optional[List[Callback]] = None) -> Tuple[Trainer, Any]:
    """Build the task and trainer from a config and run ``mode``.

    Returns the trainer and the mode's result: the last epoch's logs
    (``trainer.callback_metrics``) for ``train``, the metric logs for
    ``test``, the list of per-batch output dicts for ``predict``.
    ``callbacks`` are engine callback instances to run beside it.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported yet (available: {', '.join(MODES)})")
    if not isinstance(config, ConfigNode):
        config = config_from_dict(dict(config))
    config = merge_structured(config)

    seed_params = config.get("seed_params")
    if seed_params and seed_params.get("seed") is not None:
        seed_everything(int(seed_params.seed))

    task_params = config.task.get("params") or {}
    if hasattr(task_params, "to_dict"):
        task_params = task_params.to_dict()
    task = TASKS.get(config.task.name)(config, **task_params)
    trainer = create_trainer(config, callbacks)
    if mode == "train":
        trainer.fit(task, ckpt_path=config.get("resume_path"))
        return trainer, trainer.callback_metrics
    if mode == "test":
        return trainer, trainer.test(task, ckpt_path=config.get("resume_path"))
    return trainer, trainer.predict(task, ckpt_path=config.get("resume_path"))


def entrypoint(argv=None) -> None:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    mode, overrides = extract_mode(args.overrides)
    config = load_config(args.config_path, args.config_name, overrides)
    trainer, result = run(config, mode, [EpochPrinter()] if mode == "train" else None)
    if mode == "train":
        stats = trainer.last_fit
        print(f"{stats['steps']} train steps, {stats['images']} images in "
              f"{stats['seconds']:.3f} s on {trainer.device}")
        return
    if mode == "test":
        print(" | ".join(f"{k}={v:.6f}" for k, v in sorted(result.items())))
    else:
        print(f"predicted {len(result)} batches")
    stats = trainer.last_eval
    if mode == "test" and stats.get("seconds"):
        print(f"{stats['images']} images in {stats['seconds']:.3f} s on {trainer.device}")


if __name__ == "__main__":
    entrypoint()

"""CLI entrypoint (reference: torchok/__main__.py:13-55).

Usage, as for ``torchok_tpu``:
    python -m torchok_tpu_torch -cp <config_dir> -cn <config_name> [+mode=test] [a.b=c ...]

``entrypoint`` is ``load_config`` (YAML + overrides) followed by
``run(config, mode)``; ``run`` also takes a plain dict, which needs no
pyyaml.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Mapping, Tuple, Union

import torchok_tpu_torch  # noqa: F401 — registers all components
from torchok_tpu_torch.constructor import TASKS
from torchok_tpu_torch.constructor.config import ConfigNode, config_from_dict, load_config
from torchok_tpu_torch.constructor.config_structure import merge_structured
from torchok_tpu_torch.constructor.runner import create_trainer
from torchok_tpu_torch.engine.trainer import Trainer
from torchok_tpu_torch.utils.seed import seed_everything

MODES = ("test", "predict")


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


def run(config: Union[ConfigNode, Mapping[str, Any]], mode: str) -> Tuple[Trainer, Any]:
    """Build the task and trainer from a config and run ``mode``.

    Returns the trainer and the mode's result: the metric logs for
    ``test``, the list of per-batch output dicts for ``predict``.
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
    trainer = create_trainer(config)
    if mode == "test":
        return trainer, trainer.test(task, ckpt_path=config.get("resume_path"))
    return trainer, trainer.predict(task, ckpt_path=config.get("resume_path"))


def entrypoint(argv=None) -> None:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    mode, overrides = extract_mode(args.overrides)
    trainer, result = run(load_config(args.config_path, args.config_name, overrides), mode)
    if mode == "test":
        print(" | ".join(f"{k}={v:.6f}" for k, v in sorted(result.items())))
    else:
        print(f"predicted {len(result)} batches")
    stats = trainer.last_eval
    if mode == "test" and stats.get("seconds"):
        print(f"{stats['images']} images in {stats['seconds']:.3f} s on {trainer.device}")


if __name__ == "__main__":
    entrypoint()

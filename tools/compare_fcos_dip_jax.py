"""One set of the FCOS north star's weights validated by the port and by the
JAX package on the CPU: whether the port's decoding, NMS and mAP give the
same map50 as the JAX package's on the weights of a dip.

    python tools/compare_fcos_dip_jax.py build/fcos_dip/fcos_epoch4.pt --data build/toydet

The weights are a port ``state_dict`` saved by ``tools/probe_fcos_dip.py``;
they go into the JAX task through ``utils/flax_convert``. The toy set's
valid split is written under ``--data`` as ``chip_smoke.write_toy_detection``
writes it, and both packages test the recipe's model on it (the VALID
split as TEST, the recipe's MMDetectionMAP at IoU 0.5) in f32.
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


def test_config(data: str) -> dict:
    cfg = chip_smoke.fcos_config(data, "")
    cfg["data"] = {"TEST": cfg["data"]["VALID"]}
    cfg["metrics"][0]["phases"] = ["TEST"]
    cfg["trainer"]["accelerator"] = "cpu"
    for key in ("logger", "callbacks"):
        del cfg[key]
    return cfg


def port_map50(cfg: dict, state_dict: dict) -> float:
    import torch
    from torchok_tpu_torch.__main__ import run
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "weights.pt"
        torch.save({"state_dict": state_dict}, ckpt)
        _, logs = run({**copy.deepcopy(cfg), "resume_path": str(ckpt)}, "test")
    return float(logs["test/map50"])


def jax_map50(cfg: dict, state_dict: dict) -> float:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from torchok_tpu.constructor import TASKS
    from torchok_tpu.constructor.config import ConfigNode
    from torchok_tpu.constructor.config_structure import merge_structured
    from torchok_tpu.constructor.runner import create_trainer
    from torchok_tpu.tasks.base import BaseTask
    from torchok_tpu_torch.utils.flax_convert import state_dict_to_task_flax

    backbone = cfg["task"]["params"]["backbone_name"]
    weights = {k: np.asarray(v) for k, v in state_dict.items()}
    init = BaseTask.init_variables

    def carried(self, key, batch=None):
        shapes = jax.eval_shape(lambda k: init(self, k, batch), key)
        return {collection: state_dict_to_task_flax(backbone, weights, shapes, collection)
                for collection in shapes}

    config = merge_structured(ConfigNode(copy.deepcopy(cfg)))
    task = TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    BaseTask.init_variables = carried
    try:
        logs = create_trainer(config).test(task)
    finally:
        BaseTask.init_variables = init
    return float(logs["test/map50"])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("weights")
    parser.add_argument("--data", default="build/toydet")
    args = parser.parse_args()
    import torch
    state_dict = torch.load(args.weights, map_location="cpu", weights_only=True)
    chip_smoke.ensure_toy_detection(args.data)
    cfg = test_config(args.data)
    port = port_map50(cfg, state_dict)
    ref = jax_map50(cfg, state_dict)
    print(json.dumps({"weights": args.weights, "port_map50": port, "jax_map50": ref,
                      "difference": port - ref}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

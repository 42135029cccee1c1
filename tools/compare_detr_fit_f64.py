"""The cut DETR fit of ``tests/test_torch_detr_fit.py`` three ways on the CPU:
``torchok_tpu`` in f32, the port in f32 and the port in f64 (every parameter,
input and loss in f64). Prints each train step's loss, the validation losses
and mAPs of the three, and how far each f32 fit's parameters lie from the f64
fit's (the largest difference over a tensor's largest element).

    python tools/compare_detr_fit_f64.py

Shows how much of the distance between the packages is the JAX package's
own f32 noise: AdamW's first update moves every parameter by +-lr, so the
sign of each near-zero gradient decides it.
"""
import copy
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import tests.conftest  # noqa: E402,F401 — pins JAX to the CPU

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tests.test_torch_detr_fit as fit  # noqa: E402
from torchok_tpu_torch.__main__ import run  # noqa: E402
from torchok_tpu_torch.engine.trainer import Trainer  # noqa: E402
from torchok_tpu_torch.models.heads.detection import detr  # noqa: E402
from torchok_tpu_torch.utils.flax_convert import task_flax_to_state_dict  # noqa: E402


def _jax_fit(cfg):
    config = fit.jax_merge(fit.JaxConfigNode(copy.deepcopy(cfg)))
    task = fit.JAX_TASKS.get(config.task.name)(config, **config.task.params.to_dict())
    ref = fit.jax_create_trainer(config)
    losses = fit._JaxLosses()
    ref.callbacks.append(losses)
    initial = {}
    setup = ref._setup_state

    def setup_and_capture(task_, ckpt_path=None):
        setup(task_, ckpt_path)
        initial.update(jax.device_get({"params": ref.state.params,
                                       "batch_stats": ref.state.batch_stats}))

    ref._setup_state = setup_and_capture
    ref.fit(task)
    final = jax.device_get({"params": ref.state.params, "batch_stats": ref.state.batch_stats})
    return ref, losses.losses, initial, final


def _port_fit(cfg, ckpt, f64=False):
    """The port's fit; in f64 the model is built in f64, the batches are cast
    to f64 and ``Tensor.float`` leaves f64 tensors as they are."""
    losses = fit._PortLosses()
    if not f64:
        trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
        return trainer, losses.losses, logs
    to_float, make_device_fn, topk = torch.Tensor.float, Trainer._make_device_fn, \
        detr.topk_lower_index

    def device_fn64(self, dataset, train):
        fn = make_device_fn(self, dataset, train)
        return lambda batch: {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
                              else v for k, v in fn(batch).items()}

    torch.Tensor.float = lambda self, *a, **k: self if self.dtype == torch.float64 \
        else to_float(self, *a, **k)
    Trainer._make_device_fn = device_fn64
    detr.topk_lower_index = lambda x, k: topk(to_float(x), k)  # it orders f32 bit patterns
    torch.set_default_dtype(torch.float64)
    try:
        trainer, logs = run({**cfg, "resume_path": str(ckpt)}, "train", [losses])
    finally:
        torch.set_default_dtype(torch.float32)
        torch.Tensor.float, Trainer._make_device_fn, detr.topk_lower_index = \
            to_float, make_device_fn, topk
    return trainer, losses.losses, logs


def _distance(state, reference):
    worst = (0.0, "")
    for key, ref in reference.items():
        if not ref.is_floating_point():
            continue
        ref = ref.numpy()
        got = np.asarray(state[key], np.float64)
        worst = max(worst, (float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)), key))
    return worst


def main():
    torch.set_num_threads(1)
    tmp = Path(tempfile.mkdtemp(prefix="detr_f64_"))
    fit._write_set(tmp / "train", 12, 0)
    fit._write_set(tmp / "valid", 8, 1)
    init_variables = fit.JaxBaseTask.init_variables
    rng = np.random.default_rng(5)
    fit.JaxBaseTask.init_variables = lambda self, key, batch=None: fit.draw_variables(
        jax.eval_shape(lambda k: init_variables(self, k, batch), key), rng)
    cfg = fit._config(tmp)
    ref, jax_losses, initial, final = _jax_fit(cfg)
    ckpt = tmp / "initial.pt"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                               task_flax_to_state_dict("resnet10t", initial).items()}}, ckpt)
    t32, losses32, logs32 = _port_fit(cfg, ckpt)
    t64, losses64, logs64 = _port_fit(cfg, ckpt, f64=True)
    ref64 = t64.state.model.state_dict()
    print("train losses by step")
    for (step, a), (_, b), (_, c) in zip(jax_losses, losses32, losses64):
        print(f"  step {step}: jax f32 {a:.9f} (rel {abs(a - c) / abs(c):.2e} from f64), "
              f"port f32 {b:.9f} (rel {abs(b - c) / abs(c):.2e}), port f64 {c:.9f}")
    for key in ("valid/loss", "valid/loss_cls", "valid/loss_iou", "valid/loss_bbox",
                "valid/map50", "valid/map10"):
        a, b, c = ref.callback_metrics[key], logs32[key], logs64[key]
        print(f"{key}: jax f32 {a:.9f} (rel {abs(a - c) / max(abs(c), 1e-12):.2e} from f64), "
              f"port f32 {b:.9f} (rel {abs(b - c) / max(abs(c), 1e-12):.2e}), port f64 {c:.9f}")
    print("parameters after the fit, largest difference over a tensor's largest element, "
          "from the port's f64 fit:")
    print(f"  jax f32 {_distance(task_flax_to_state_dict('resnet10t', final), ref64)}")
    port32 = {k: v.numpy() for k, v in t32.state.model.state_dict().items()}
    print(f"  port f32 {_distance(port32, ref64)}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()

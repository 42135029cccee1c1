"""Training and evaluation engine (port of ``torchok_tpu.engine.trainer``;
reference: torchok/constructor/runner.py + Lightning internals).

* The trainer holds an explicit ``torch.device`` resolved from
  ``trainer.accelerator``: ``gpu``, ``cuda`` and ``auto`` mean the first CUDA
  card and raise when there is none; ``cpu`` means the CPU. Nothing falls
  back to the CPU quietly.
* Model weights are drawn from a ``torch.Generator`` seeded from
  ``seed_params.seed``, or loaded from ``ckpt_path`` (a ``torch.save`` of a
  ``state_dict``, optionally under a ``"state_dict"`` key). Every dropout
  and drop-path draw comes from one device generator seeded ``seed + 7``;
  nothing reads torch's global generator.
* Input pipeline: loader threads fetch and collate numpy batches; the batch
  is copied to the device and the dataset's device transform suffix runs
  there, batched.
* ``precision: 16`` (or ``bf16``) runs the forward and the loss under
  ``torch.autocast(device, torch.bfloat16)``; parameters, gradients and
  optimizer state stay f32, and bf16 needs no loss scaling. Every eval step
  runs under ``torch.inference_mode()``.
* One train step is forward, ``task.compute_loss``, backward and, on every
  ``accumulate_grad_batches``-th step, clip + optimizer step on the mean
  gradient. Losses are summed on the device and read back once per log
  interval and once per epoch, so no step waits for the host.
* Host-side schedulers: the engine asks the scheduler for the lr (per epoch
  or per step) and writes ``base_lr * factor`` into every param group.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchok_tpu_torch.constructor.config import ConfigNode
from torchok_tpu_torch.constructor.config_structure import Phase, TrainerParams
from torchok_tpu_torch.constructor.constructor import norm_parameter_names
from torchok_tpu_torch.engine.callbacks import Callback
from torchok_tpu_torch.engine.state import TrainState
from torchok_tpu_torch.ops.common import install_dropout_generator

# trainer keys the engine reads
_HONOURED = frozenset({
    "accelerator", "precision", "limit_test_batches", "limit_predict_batches",
    "max_epochs", "min_epochs", "max_steps", "min_steps", "limit_train_batches",
    "limit_val_batches", "check_val_every_n_epoch", "num_sanity_val_steps",
    "log_every_n_steps", "accumulate_grad_batches", "gradient_clip_val",
    "gradient_clip_algorithm",
})
# fit-loop keys that are not ported: a recipe that sets them still runs in
# test/predict mode (they change nothing there) and raises in fit
_FIT_RAISES = frozenset({
    "steps_per_execution", "overfit_batches", "val_check_interval", "max_time",
    "reload_dataloaders_every_n_epochs", "enable_checkpointing", "detect_anomaly",
})
# checkpoint entries beside "state_dict" that a fit cannot resume from yet
_OPTIMIZER_STATE_KEYS = frozenset({"optimizer", "optimizers", "optimizer_states", "opt_state"})
# keys that change nothing on one device with one TRAIN loader
_INERT = frozenset({"multiple_trainloader_mode", "sync_batchnorm", "use_distributed_sampler"})


def _non_default(tp: ConfigNode, names) -> List[Tuple[str, Any, Any]]:
    out = []
    for f in dataclasses.fields(TrainerParams):
        if f.name in names:
            value = tp.get(f.name, f.default)
            # a falsy value where the default is falsy (None, 0, False) is the default
            if value != f.default and (value or f.default):
                out.append((f.name, value, f.default))
    return out


def _check_ported(tp: ConfigNode) -> None:
    """Raise on a trainer key the engine does not honour in any mode when it
    is set away from its default, so no recipe quietly runs something else."""
    known = _HONOURED | _FIT_RAISES | _INERT
    rest = [f.name for f in dataclasses.fields(TrainerParams) if f.name not in known]
    for name, value, default in _non_default(tp, rest):
        if name == "devices" and str(value) in ("1", "-1"):
            continue
        raise NotImplementedError(
            f"trainer.{name}={value!r} is not ported yet (only {default!r} runs)")


def _check_fit_ported(tp: ConfigNode) -> None:
    """The same for the keys that steer only the fit loop."""
    for name, value, default in _non_default(tp, _FIT_RAISES):
        raise NotImplementedError(
            f"trainer.{name}={value!r} is not ported yet in fit (only {default!r} runs)")


def resolve_device(accelerator: Optional[str]) -> torch.device:
    """trainer.accelerator -> torch.device; raises when the card is absent."""
    acc = str(accelerator or "auto").lower()
    if acc in ("gpu", "cuda", "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"trainer.accelerator={acc} needs a CUDA device and none is "
                "available; set trainer.accelerator=cpu to run on the CPU")
        return torch.device("cuda", 0)
    if acc == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.accelerator={accelerator!r}: expected gpu, cuda, auto or cpu")


class Trainer:
    def __init__(self, trainer_params: ConfigNode,
                 callbacks: Optional[List[Callback]] = None, seed: int = 0):
        tp = trainer_params
        _check_ported(tp)
        self.params = tp
        self.callbacks = callbacks or []
        self.seed = seed

        self.max_epochs = tp.get("max_epochs") or 1
        self.min_epochs = tp.get("min_epochs") or 0
        self.max_steps = tp.get("max_steps", -1)
        self.min_steps = tp.get("min_steps") or 0
        self.limit_train_batches = tp.get("limit_train_batches")
        self.limit_val_batches = tp.get("limit_val_batches")
        self.limit_test_batches = tp.get("limit_test_batches")
        self.limit_predict_batches = tp.get("limit_predict_batches")
        self.check_val_every_n_epoch = tp.get("check_val_every_n_epoch") or 1
        self.log_every_n_steps = tp.get("log_every_n_steps") or 50
        self.accumulate_grad_batches = tp.get("accumulate_grad_batches") or 1
        self.gradient_clip_val = tp.get("gradient_clip_val")
        self.gradient_clip_algorithm = tp.get("gradient_clip_algorithm") or "norm"
        if self.gradient_clip_algorithm not in ("norm", "value"):
            raise ValueError(
                "trainer.gradient_clip_algorithm must be 'norm' or 'value', "
                f"got {self.gradient_clip_algorithm!r}")
        sanity = tp.get("num_sanity_val_steps")
        # Lightning default: 2 sanity batches before training (explicit 0 disables)
        self.num_sanity_val_steps = 2 if sanity is None else int(sanity)
        self.device = resolve_device(tp.get("accelerator"))

        # populated during fit / test / predict
        self.state: Optional[TrainState] = None
        self.task = None
        self.bundles: List[Any] = []
        self.current_epoch = 0
        self.global_step = 0
        self.callback_metrics: Dict[str, float] = {}
        self.should_stop = False
        # images and host seconds of the last eval loop, first batch fetch to
        # the metrics read-back (which waits for the device)
        self.last_eval: Dict[str, float] = {}
        # train steps, images and host seconds of the last fit, summed over
        # its epochs: first batch fetch to the epoch's loss read-back
        self.last_fit: Dict[str, float] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _limit(n_batches: int, limit) -> int:
        if limit is None:
            return n_batches
        if isinstance(limit, float) and limit <= 1.0:
            return max(1, int(n_batches * limit))
        return min(n_batches, int(limit))

    def _make_device_fn(self, dataset, train: bool) -> Callable:
        pipe = dataset.device_pipeline
        device = self.device
        generator = torch.Generator(device=device)
        generator.manual_seed(self.seed + (17 if train else 31))

        def device_fn(host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            batch = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()
                     if isinstance(v, np.ndarray)}
            if pipe:
                batch = pipe(batch, generator)
            if not batch["image"].is_floating_point():
                batch["image"] = batch["image"].float()
            return batch

        return device_fn

    def _install_device_fns(self, loaders: Sequence, train: bool) -> None:
        for ld in loaders:
            ld.device_fn = self._make_device_fn(ld.dataset, train)

    # ------------------------------------------------------------------
    # optimizer plumbing
    # ------------------------------------------------------------------
    def _clip_gradients(self, params: List[torch.Tensor]) -> None:
        """optax's clips, on the device with no read-back: 'norm' scales by
        ``clip / norm`` only when the global norm exceeds ``clip``; 'value'
        clamps each element to +-clip."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        clip = float(self.gradient_clip_val)
        if self.gradient_clip_algorithm == "value":
            torch._foreach_clamp_min_(grads, -clip)
            torch._foreach_clamp_max_(grads, clip)
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        torch._foreach_mul_(grads, scale)

    def _apply_lr_factor(self, factor: float, bundle_idx: int = 0) -> None:
        for group in self.bundles[bundle_idx].optimizer.param_groups:
            group["lr"] = group["base_lr"] * factor

    def current_lr(self) -> float:
        if self.bundles and self.bundles[0].scheduler is not None:
            return self.bundles[0].scheduler.current_lr
        if self.bundles:
            return self.bundles[0].optimizer.param_groups[0]["base_lr"]
        return 0.0

    # ------------------------------------------------------------------
    # step functions
    # ------------------------------------------------------------------
    def _autocast(self, task):
        dtype = task.compute_dtype
        return torch.autocast(self.device.type, dtype=dtype, enabled=dtype is not None)

    def _make_train_step(self, task) -> Callable:
        """One train step: forward, loss, backward and, on every
        ``accumulate_grad_batches``-th call, clip + optimizer step on the mean
        of the accumulated gradients (``optax.MultiSteps(chain(clip, tx))``
        in ``torchok_tpu``). Returns detached outputs and losses."""
        state = self.state
        model = state.model
        params = [p for p in model.parameters() if p.requires_grad]
        every = self.accumulate_grad_batches

        def train_step(batch: Dict[str, torch.Tensor]):
            with self._autocast(task):
                outputs = model(batch)
                total, tagged = task.compute_loss(outputs)
            (total / every if every > 1 else total).backward()
            state.step += 1
            if state.step % every == 0:
                if self.gradient_clip_val:
                    self._clip_gradients(params)
                for optimizer in state.optimizers:
                    optimizer.step()
                model.zero_grad(set_to_none=True)
            outputs = {k: v.detach() if torch.is_tensor(v) else v for k, v in outputs.items()}
            losses = {"loss": total.detach(), **{k: v.detach() for k, v in tagged.items()}}
            return outputs, losses

        return train_step

    def _make_eval_step(self, task, with_loss: bool = False) -> Callable:
        model = self.state.model
        has_losses = with_loss and task.losses is not None

        def eval_step(batch: Dict[str, torch.Tensor]):
            with torch.inference_mode(), self._autocast(task):
                outputs = model(batch)
                losses = {}
                if has_losses:
                    total, tagged = task.compute_loss(outputs)
                    losses = {"loss": total, **tagged}
                return outputs, losses

        return eval_step

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _setup_state(self, task, ckpt_path: Optional[str] = None, fit: bool = False) -> None:
        generator = torch.Generator()
        generator.manual_seed(self.seed)
        task.init_weights(generator)
        if ckpt_path:
            ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            if fit and "state_dict" in ckpt and set(ckpt) & _OPTIMIZER_STATE_KEYS:
                raise NotImplementedError(
                    f"resuming optimizer state ({sorted(set(ckpt) & _OPTIMIZER_STATE_KEYS)}) "
                    "is not ported yet; save only the state_dict to start from its weights")
            task.model.load_state_dict(ckpt.get("state_dict", ckpt), strict=True)
        model = task.model.to(self.device).eval()
        self.state = TrainState(model=model)
        if not fit:
            return
        dropout_generator = torch.Generator(device=self.device)
        dropout_generator.manual_seed(self.seed + 7)
        install_dropout_generator(model, dropout_generator)
        self.state.dropout_generator = dropout_generator
        optimization = task.hparams.get("optimization") or []
        if len(optimization) > 1:
            raise NotImplementedError(
                f"{len(optimization)} optimization groups: only one is ported yet")
        self.bundles = task.constructor.configure_optimizers(
            model.named_parameters(), task.no_weight_decay(),
            norm_names=norm_parameter_names(model)) if optimization else []
        self.state.optimizers = [b.optimizer for b in self.bundles]

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def fit(self, task, ckpt_path: Optional[str] = None) -> None:
        self.task = task
        try:
            self._fit_inner(task, ckpt_path)
        except BaseException as e:  # noqa: BLE001 — callbacks see any failure, then it is raised
            for cb in self.callbacks:
                cb.on_exception(self, task, e)
            raise

    def _fit_inner(self, task, ckpt_path: Optional[str]) -> None:
        _check_fit_ported(self.params)
        if task.hparams.task.get("load_checkpoint"):
            raise NotImplementedError("task.load_checkpoint is not ported yet")
        train_loaders = task.train_dataloader()
        if not train_loaders:
            raise ValueError("No TRAIN data configured")
        if len(train_loaders) > 1:
            raise NotImplementedError(
                f"{len(train_loaders)} TRAIN dataloaders: only one is ported yet")
        val_loaders = task.val_dataloader()
        self._setup_state(task, ckpt_path, fit=True)
        self._install_device_fns(val_loaders, train=False)
        self._install_device_fns(train_loaders, train=True)
        self._fit_loop(task, train_loaders[0], val_loaders, self._make_train_step(task))

    def _fit_loop(self, task, train_loader, val_loaders, train_step) -> None:
        eval_step = self._make_eval_step(task, task.compute_loss_on_valid)
        model = self.state.model
        micro_batch = train_loader.batch_size

        for cb in self.callbacks:
            cb.setup(self, task)
        for cb in self.callbacks:
            cb.on_fit_start(self, task)

        n_train = self._limit(len(train_loader), self.limit_train_batches)
        hard_stop = False  # max_steps overrides min_epochs|steps
        self.last_fit = {"steps": 0, "images": 0, "seconds": 0.0}

        # sanity validation (Lightning parity): a few val batches before
        # training starts, so metric/loss plumbing fails fast
        if self.num_sanity_val_steps and val_loaders:
            self._run_eval(task, eval_step, val_loaders, Phase.VALID,
                           limit=self.num_sanity_val_steps)

        for epoch in range(self.current_epoch, self.max_epochs):
            self.current_epoch = epoch
            epoch_logs: Dict[str, float] = {}
            for cb in self.callbacks:
                cb.on_train_epoch_start(self, task)

            # ----- train epoch -----
            model.train()
            t0 = time.perf_counter()
            train_loader.set_epoch(epoch)
            # the sums stay on the device: a float() per step would make
            # every step wait for the host
            loss_sums: Dict[str, torch.Tensor] = {}
            n_steps = 0
            for bidx, batch in enumerate(train_loader):
                if bidx >= n_train:
                    break
                outputs, losses = train_step(batch)
                task.metrics_manager.update(Phase.TRAIN, 0, **outputs)
                prev_step = self.global_step
                n_steps += 1
                self.global_step += 1
                for k, v in losses.items():
                    loss_sums[k] = v if k not in loss_sums else loss_sums[k] + v
                # step-interval schedulers advance once per train step
                for b_idx, bundle in enumerate(self.bundles):
                    if bundle.scheduler is None or bundle.scheduler_interval != "step":
                        continue
                    if self.global_step // bundle.scheduler_frequency \
                            > prev_step // bundle.scheduler_frequency:
                        new_lr = bundle.scheduler.step()
                        self._apply_lr_factor(new_lr / bundle.scheduler.base_lr
                                              if bundle.scheduler.base_lr else 1.0, b_idx)
                if (self.global_step // self.log_every_n_steps
                        > prev_step // self.log_every_n_steps) and self.callbacks:
                    host_losses = {k: float(v) for k, v in losses.items()}
                    for cb in self.callbacks:
                        cb.on_train_batch_end(self, task, self.global_step, host_losses)
                if 0 < self.max_steps <= self.global_step:
                    self.should_stop = hard_stop = True
                    break
            host_sums = {k: float(v) for k, v in loss_sums.items()}  # waits for the device
            epoch_time = time.perf_counter() - t0
            self.last_fit["steps"] += n_steps
            self.last_fit["images"] += n_steps * micro_batch
            self.last_fit["seconds"] += epoch_time

            train_logs = {f"train/{k}": v / max(n_steps, 1) for k, v in host_sums.items()}
            train_logs.update(task.metrics_manager.on_epoch_end(Phase.TRAIN))
            train_logs["train/epoch_time_s"] = epoch_time
            if n_steps:
                train_logs["train/images_per_sec"] = n_steps * micro_batch / epoch_time
            epoch_logs.update(train_logs)
            for cb in self.callbacks:
                cb.on_train_epoch_end(self, task, train_logs)

            # ----- validation -----
            if val_loaders and (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_logs = self._run_eval(task, eval_step, val_loaders, Phase.VALID)
                epoch_logs.update(val_logs)
                for cb in self.callbacks:
                    cb.on_validation_epoch_end(self, task, val_logs)

            # ----- schedulers -----
            for b_idx, bundle in enumerate(self.bundles):
                sched = bundle.scheduler
                if sched is None or bundle.scheduler_interval != "epoch":
                    continue
                if (epoch + 1) % bundle.scheduler_frequency == 0:
                    new_lr = sched.step(epoch_logs.get(bundle.scheduler_monitor))
                    self._apply_lr_factor(new_lr / sched.base_lr if sched.base_lr else 1.0,
                                          b_idx)
            epoch_logs["lr"] = self.current_lr()

            self.callback_metrics = dict(epoch_logs)
            for cb in self.callbacks:
                cb.on_epoch_end(self, task, epoch_logs)

            if hard_stop:  # max_steps wins over min_epochs|steps
                break
            if self.should_stop or any(cb.should_stop(self) for cb in self.callbacks):
                # early stops wait out both floors (Lightning min_epochs AND
                # min_steps semantics)
                if epoch + 1 >= self.min_epochs and self.global_step >= self.min_steps:
                    break

        for cb in self.callbacks:
            cb.on_fit_end(self, task)

    def _run_eval(self, task, eval_step, loaders, phase: Phase, limit=None) -> Dict[str, float]:
        if limit is None:
            limit = self.limit_val_batches if phase == Phase.VALID else self.limit_test_batches
        self.state.model.eval()
        n_images = 0
        n_steps = 0
        loss_sums: Dict[str, torch.Tensor] = {}
        start = time.perf_counter()
        with torch.inference_mode():
            for dl_idx, loader in enumerate(loaders):
                n_batches = self._limit(len(loader), limit)
                for bidx, batch in enumerate(loader):
                    if bidx >= n_batches:
                        break
                    outputs, losses = eval_step(batch)
                    task.metrics_manager.update(phase, dl_idx, **outputs)
                    for k, v in losses.items():
                        loss_sums[k] = v if k not in loss_sums else loss_sums[k] + v
                    n_steps += 1
                    n_images += batch["image"].shape[0]
            logs = {f"{phase.value}/{k}": float(v) / max(n_steps, 1)
                    for k, v in loss_sums.items()}
            logs.update(task.metrics_manager.on_epoch_end(phase))
        self.last_eval = {"images": n_images, "seconds": time.perf_counter() - start}
        return logs

    def _prepare(self, task, loaders, ckpt_path: Optional[str]) -> Callable:
        self.task = task
        if self.state is None:
            self._setup_state(task, ckpt_path)
        self._install_device_fns(loaders, train=False)
        return self._make_eval_step(task)

    def test(self, task, ckpt_path: Optional[str] = None) -> Dict[str, float]:
        loaders = task.test_dataloader()
        eval_step = self._prepare(task, loaders, ckpt_path)
        logs = self._run_eval(task, eval_step, loaders, Phase.TEST,
                              limit=self.limit_test_batches)
        self.callback_metrics = dict(logs)
        for cb in self.callbacks:
            cb.on_test_end(self, task, logs)
        return logs

    def predict(self, task, ckpt_path: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
        loaders = task.predict_dataloader()
        eval_step = self._prepare(task, loaders, ckpt_path)
        self.state.model.eval()
        results = []
        for loader in loaders:
            n_batches = self._limit(len(loader), self.limit_predict_batches)
            for bidx, batch in enumerate(loader):
                if bidx >= n_batches:
                    break
                outputs, _ = eval_step(batch)
                results.append({k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                                for k, v in outputs.items()})
        return results

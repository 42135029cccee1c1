"""Training and evaluation engine (port of ``torchok_tpu.engine.trainer``;
reference: torchok/constructor/runner.py + Lightning internals).

* The trainer holds an explicit ``torch.device`` resolved from
  ``trainer.accelerator``: ``gpu``, ``cuda`` and ``auto`` mean the first CUDA
  card and raise when there is none; ``cpu`` means the CPU. Nothing falls
  back to the CPU quietly.
* Model weights are drawn from a ``torch.Generator`` seeded from
  ``seed_params.seed``, or loaded from ``ckpt_path`` (a ``torch.save`` of a
  ``state_dict``, optionally under a ``"state_dict"`` key). A ModelCheckpoint
  file (it holds an ``epoch``) resumes a fit where it stopped: optimizers,
  schedulers, generators, epoch and step counts. Every dropout and
  drop-path draw comes from one device generator seeded ``seed + 7``, every
  random device transform of the train set from one seeded ``seed + 17``;
  nothing reads torch's global generator. Host-side random transforms draw
  from a generator per sample made from the loader's seed, the epoch and
  the sample's index (``ImageDataset.seed``), so a resume needs only the
  epoch to redraw them.
* A module's buffers (ArcFace's dynamic-margin ``step``, BatchNorm's running
  statistics) move in training forwards only, one forward per micro-batch
  (``torchok_tpu``'s ``buffers`` and ``batch_stats`` collections, threaded
  through its train step); they live in the model's ``state_dict``, so a
  checkpoint carries them.
* Input pipeline: loader threads fetch and collate numpy batches; the batch
  is copied to the device and the dataset's device transform suffix runs
  there, batched.
* ``precision: 16`` (or ``bf16``) runs the forward and the loss under
  ``torch.autocast(device, torch.bfloat16)``; parameters, gradients and
  optimizer state stay f32, and bf16 needs no loss scaling. Every eval step
  runs under ``torch.inference_mode()``.
* One train step is forward, ``task.compute_loss``, backward and, on every
  ``accumulate_grad_batches``-th step, clip + optimizer step on the mean
  gradient. A parameter frozen by ``TrainState.set_masks`` (FreezeUnfreeze)
  or left out of the loss gets a zero gradient there, before the clip, and
  is stepped all the same, as the JAX package's masked gradients are; a
  frozen BatchNorm keeps its running statistics. Losses are summed on the
  device and read back once per log interval and once per epoch, so no
  step waits for the host.
* Host-side schedulers: the engine asks the scheduler for the lr (per epoch
  or per step) and writes ``base_lr * factor`` into every param group.
* ``steps_per_execution: K`` (``torchok_tpu``'s fused multi-step): the TRAIN
  loader serves super-batches of K micro-batches (``drop_last`` applies to
  the super-batch), one host fetch, copy and device-transform run each; the
  engine runs their K steps in a row (a ragged tail: its full micro-batches,
  then one step on the rest). Train limits count optimizer steps,
  step-interval schedulers fire between executions, and each execution
  contributes the mean of its steps' losses.
* A logger (``logger:``) gets the hyperparameters at fit start, the train
  losses every ``log_every_n_steps``, the epoch logs, the test logs and the
  final status.
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
    "gradient_clip_algorithm", "steps_per_execution",
    # read by create_trainer
    "enable_checkpointing", "enable_model_summary", "barebones",
})
# fit-loop keys that are not ported: a recipe that sets them still runs in
# test/predict mode (they change nothing there) and raises in fit
_FIT_RAISES = frozenset({
    "overfit_batches", "val_check_interval", "max_time",
    "reload_dataloaders_every_n_epochs", "detect_anomaly",
})
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


def _map_tensors(fn: Callable[[torch.Tensor], Any], value: Any) -> Any:
    """``fn`` applied to every tensor of an output value: a tensor, or a
    list, tuple or dict of them (a detection head's per-level maps, its
    ``prediction`` dict); anything else as it is."""
    if torch.is_tensor(value):
        return fn(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_map_tensors(fn, v) for v in value)
    if isinstance(value, dict):
        return {k: _map_tensors(fn, v) for k, v in value.items()}
    return value


def _close(loaders: Sequence) -> None:
    """Stop the loaders' worker processes, if they started any."""
    for loader in loaders:
        loader.close()


def _host(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


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
    def __init__(self, trainer_params: ConfigNode, logger_backend=None,
                 callbacks: Optional[List[Callback]] = None, seed: int = 0):
        tp = trainer_params
        _check_ported(tp)
        self.params = tp
        self.logger = logger_backend
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
        self.steps_per_execution = max(1, tp.get("steps_per_execution") or 1)
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
        if train:  # a checkpoint carries its state
            generator = self.state.transform_generator
        else:
            generator = torch.Generator(device=device)
            generator.manual_seed(self.seed + 31)

        def device_fn(host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            batch = {k: torch.from_numpy(v).to(device) for k, v in host_batch.items()
                     if isinstance(v, np.ndarray)}
            if pipe:
                batch = pipe(batch, generator)
            if not batch["image"].is_floating_point():
                batch["image"] = batch["image"].float()
            # segmentation labels ride the device pipeline as 'mask' (its
            # geometric ops move them with the image); tasks take 'target'
            if "mask" in batch and "target" not in batch:
                batch["target"] = batch.pop("mask")
            return batch

        return device_fn

    def _install_device_fns(self, loaders: Sequence, train: bool) -> None:
        for ld in loaders:
            ld.device_fn = self._make_device_fn(ld.dataset, train)
            # on a card the host feeds kernels from the main thread: samples
            # load in worker processes, off its GIL (data/loader.py)
            ld.worker_processes = self.device.type == "cuda"

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
        params = list(model.parameters())
        every = self.accumulate_grad_batches

        def train_step(batch: Dict[str, torch.Tensor]):
            with self._autocast(task):
                outputs = model(batch)
                total, tagged = task.compute_loss(outputs)
            (total / every if every > 1 else total).backward()
            state.step += 1
            if state.step % every == 0:
                # the JAX step multiplies every gradient by grad_mask and
                # updates every parameter: a frozen (or unused) one takes
                # zeros, never None, so weight decay and momentum still move it
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if self.gradient_clip_val:
                    self._clip_gradients(params)
                for optimizer in state.optimizers:
                    optimizer.step()
                model.zero_grad(set_to_none=True)
            outputs = {k: _map_tensors(torch.Tensor.detach, v) for k, v in outputs.items()}
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
        from torchok_tpu_torch.callbacks.model_checkpoint import (restore_train_state,
                                                                  wait_for_pending_saves)
        generator = torch.Generator()
        generator.manual_seed(self.seed)
        task.init_weights(generator)
        ckpt = None
        if ckpt_path:
            wait_for_pending_saves()  # a background write may still be in flight
            ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            task.model.load_state_dict(ckpt.get("state_dict", ckpt), strict=True)
        model = task.model.to(self.device).eval()
        self.state = TrainState(model=model)
        if not fit:
            return
        dropout_generator = torch.Generator(device=self.device)
        dropout_generator.manual_seed(self.seed + 7)
        install_dropout_generator(model, dropout_generator)
        self.state.dropout_generator = dropout_generator
        self.state.transform_generator = torch.Generator(device=self.device)
        self.state.transform_generator.manual_seed(self.seed + 17)
        optimization = task.hparams.get("optimization") or []
        if len(optimization) > 1:
            raise NotImplementedError(
                f"{len(optimization)} optimization groups: only one is ported yet")
        self.bundles = task.constructor.configure_optimizers(
            model.named_parameters(), task.no_weight_decay(),
            norm_names=norm_parameter_names(model)) if optimization else []
        self.state.optimizers = [b.optimizer for b in self.bundles]
        if ckpt is not None and "epoch" in ckpt:  # a ModelCheckpoint file: resume
            restore_train_state(ckpt, self)

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
        train_loader = train_loaders[0]
        micro_batch = train_loader.batch_size
        # the loader serves super-batches of K micro-batches; restored after
        # the fit so that a second fit does not compound the scaling
        train_loader.batch_size = micro_batch * self.steps_per_execution
        try:
            self._fit_loop(task, train_loader, val_loaders, self._make_train_step(task),
                           micro_batch)
        finally:
            train_loader.batch_size = micro_batch
            _close(train_loaders + val_loaders)

    def _execute(self, task, train_step, batch: Dict[str, torch.Tensor], micro_batch: int
                 ) -> Tuple[Dict[str, torch.Tensor], int]:
        """One execution: the steps of a (super-)batch and the mean of their
        losses, as ``torchok_tpu``'s fused scan averages them (a ragged tail's
        remainder step weighs in as one more step). Returns the losses and
        the count of optimizer steps run."""
        if self.steps_per_execution == 1:
            outputs, losses = train_step(batch)
            task.metrics_manager.update(Phase.TRAIN, 0, **outputs)
            return losses, 1
        size = batch["image"].shape[0]
        k, rem = divmod(size, micro_batch)
        bounds = [(i * micro_batch, (i + 1) * micro_batch) for i in range(k)]
        if rem:
            bounds.append((k * micro_batch, size))
        per_step = []
        for lo, hi in bounds:
            outputs, losses = train_step({key: v[lo:hi] for key, v in batch.items()})
            task.metrics_manager.update(Phase.TRAIN, 0, **outputs)
            per_step.append(losses)
        if not k:
            return per_step[0], 1
        mean = {key: torch.stack([s[key] for s in per_step[:k]]).mean(0) for key in per_step[0]}
        if rem:
            mean = {key: (v * k + per_step[k][key]) / (k + 1) for key, v in mean.items()}
        return mean, len(bounds)

    def _fit_loop(self, task, train_loader, val_loaders, train_step, micro_batch: int) -> None:
        eval_step = self._make_eval_step(task, task.compute_loss_on_valid)
        model = self.state.model
        spe = self.steps_per_execution

        for cb in self.callbacks:
            cb.setup(self, task)
        for cb in self.callbacks:
            cb.on_fit_start(self, task)
        if self.logger is not None:
            self.logger.log_hyperparams(task.hparams)

        n_train = self._limit(len(train_loader), self.limit_train_batches)  # executions
        if spe > 1 and self.limit_train_batches is not None:  # the limit counts steps
            limit_steps = self._limit(len(train_loader) * spe, self.limit_train_batches)
            n_train = min(len(train_loader), max(1, (limit_steps + spe - 1) // spe))
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
            n_execs = 0
            for bidx, batch in enumerate(train_loader):
                if bidx >= n_train:
                    break
                losses, executed = self._execute(task, train_step, batch, micro_batch)
                prev_step = self.global_step
                n_steps += executed
                n_execs += 1
                self.global_step += executed
                for k, v in losses.items():
                    loss_sums[k] = v if k not in loss_sums else loss_sums[k] + v
                # step-interval schedulers advance once per optimizer step; with
                # steps_per_execution the lr moves between executions
                for b_idx, bundle in enumerate(self.bundles):
                    if bundle.scheduler is None or bundle.scheduler_interval != "step":
                        continue
                    fired = (self.global_step // bundle.scheduler_frequency
                             - prev_step // bundle.scheduler_frequency)
                    if fired <= 0:
                        continue
                    for _ in range(fired):
                        new_lr = bundle.scheduler.step()
                    self._apply_lr_factor(new_lr / bundle.scheduler.base_lr
                                          if bundle.scheduler.base_lr else 1.0, b_idx)
                if (self.global_step // self.log_every_n_steps
                        > prev_step // self.log_every_n_steps) \
                        and (self.callbacks or self.logger is not None):
                    host_losses = {k: float(v) for k, v in losses.items()}
                    if self.logger is not None:
                        self.logger.log_metrics({f"train/{k}": v for k, v in host_losses.items()},
                                                step=self.global_step)
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

            # each execution contributes the mean of its steps' losses
            train_logs = {f"train/{k}": v / max(n_execs, 1) for k, v in host_sums.items()}
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
            if self.logger is not None:
                self.logger.log_metrics(epoch_logs, step=self.global_step)
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
        if self.logger is not None:
            self.logger.finalize("success")

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
        try:
            logs = self._run_eval(task, eval_step, loaders, Phase.TEST,
                                  limit=self.limit_test_batches)
        finally:
            _close(loaders)
        self.callback_metrics = dict(logs)
        if self.logger is not None:
            self.logger.log_metrics(logs, step=self.global_step)
            self.logger.finalize("success")
        for cb in self.callbacks:
            cb.on_test_end(self, task, logs)
        return logs

    def predict(self, task, ckpt_path: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
        loaders = task.predict_dataloader()
        eval_step = self._prepare(task, loaders, ckpt_path)
        self.state.model.eval()
        results = []
        try:
            for loader in loaders:
                n_batches = self._limit(len(loader), self.limit_predict_batches)
                for bidx, batch in enumerate(loader):
                    if bidx >= n_batches:
                        break
                    outputs, _ = eval_step(batch)
                    results.append({k: _map_tensors(_host, v) for k, v in outputs.items()})
        finally:
            _close(loaders)
        return results

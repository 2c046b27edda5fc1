"""Training loop: optimizer, train and validation steps, metrics, checkpoints.

The port of `matcha_tpu/train/trainer.py`, with the same hyperparameters:

  * AdamW, lr 1e-4, betas (0.9, 0.999), weight decay 1e-6, per-epoch cosine
    annealing to 1e-6 over 1000 epochs;
  * global-norm clipping at 1.0 and 2-step gradient accumulation;
  * loss = duration + prior + flow matching; `precision="bf16"` runs the U-Net
    on a bf16 view of f32 master weights (`models/precision.py`);
  * checkpoints: top-k on validation loss plus the latest, auto-resume;
  * metrics to JSONL, and TensorBoard scalars when it imports.

The optimizer reproduces the JAX package's optax chain,
MultiSteps(chain(clip_by_global_norm, adamw)), update for update:
  * clipping is optax's: g where ||g|| < max, else g / ||g|| * max (no epsilon);
  * the accumulator is a running mean, acc + (g - acc) / (i + 1), and the
    parameters do not move on the steps that emit no update;
  * the learning-rate schedule counts emitted updates, not micro-steps, and
    takes micro-steps per epoch as its epoch length, as the JAX trainer feeds
    it: with accumulation 2 its epoch index advances at half the data's rate.
The logged grad_norm is the norm of each micro-step's gradient before clipping.

Randomness of the batch at schedule index i of epoch e (CFM t and z, crop
offsets, dropout) comes from generators seeded by (seed + 1, e, i), and of
validation batch i by (seed + 2, e, i): a run's trajectory does not depend on
where it was resumed.
"""

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.data.dataset import DataConfig, batch_iterator, num_batches
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.train.checkpoints import CheckpointStore


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    betas: tuple = (0.9, 0.999)
    weight_decay: float = 1e-6
    cosine_epochs: int = 1000  # cosine period in epochs
    eta_min: float = 1e-6
    grad_clip: float = 1.0
    accumulate_steps: int = 2
    max_epochs: int = 1000
    log_every: int = 10
    ckpt_dir: str = "checkpoints"
    keep_top_k: int = 3
    seed: int = 0
    # the port has one MAS: the kernels on the card, the plain version on the CPU
    mas_impl: str = "auto"
    log_grad_norm: bool = True
    precision: str = "fp32"  # or "bf16": bf16 U-Net on f32 master weights
    profile_dir: Optional[str] = None  # not ported yet (ROADMAP)
    # train the decoder on a random window of this many frames per sample
    out_size: Optional[int] = None
    ckpt_every_epochs: int = 1
    steps_per_dispatch: int = 1  # only 1; K-step capture is not ported yet (ROADMAP)


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """count -> learning rate: cosine annealing by whole epochs of `steps_per_epoch`."""

    def schedule(count: int) -> float:
        epoch = min(count // max(steps_per_epoch, 1), cfg.cosine_epochs)
        cos = 0.5 * (1 + math.cos(math.pi * epoch / cfg.cosine_epochs))
        return cfg.eta_min + (cfg.lr - cfg.eta_min) * cos

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-d tensor (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class AccumulatingAdamW:
    """optax.MultiSteps(chain(clip_by_global_norm, adamw(schedule)), k) on a parameter list.

    `step(grads)` takes one micro-step's gradients and returns whether it
    emitted an update. The update runs as multi-tensor (`torch._foreach_*`)
    operations, a few launches for all parameters, and never reads a value
    back to the host: the clip factor stays on the device.
    """

    def __init__(self, params, cfg: TrainConfig, steps_per_epoch: int):
        self.params = list(params)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.mini_step = 0
        self.count = 0  # emitted updates
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> bool:
        cfg = self.cfg
        delta = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(self.acc, delta)  # acc + (g - acc) / (i + 1)
        if self.mini_step + 1 < cfg.accumulate_steps:
            self.mini_step += 1
            return False
        norm = global_norm(self.acc)
        clip = torch.where(norm < cfg.grad_clip, torch.ones_like(norm), cfg.grad_clip / norm)
        g = torch._foreach_mul(self.acc, clip)
        b1, b2 = cfg.betas
        count = self.count + 1
        lr = self.schedule(self.count)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - b2)
        denom = torch._foreach_div(self.nu, 1 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        update = torch._foreach_div(self.mu, 1 - b1 ** count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=cfg.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        torch._foreach_zero_(self.acc)
        self.count = count
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "count": self.count,
                "acc": self.acc, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step, self.count = int(state["mini_step"]), int(state["count"])
        for name in ("acc", "mu", "nu"):
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(src)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, params) -> AccumulatingAdamW:
    return AccumulatingAdamW(params, cfg, steps_per_epoch)


def total_loss(losses: dict) -> torch.Tensor:
    return losses["dur_loss"] + losses["prior_loss"] + losses["diff_loss"]


def chunk_batches_by_shape(batches, k: int, window: int = 64):
    """Group a batch stream into lists of <= k identically shaped batches, in an
    order that does not depend on k (windows of `window` items, each stably
    sorted by shape). Items are batch dicts or (batch dict, aux) tuples."""
    window = max(window, k)

    def shape_of(item):
        b = item[0] if isinstance(item, tuple) else item
        return tuple(sorted((name, np.shape(v)) for name, v in b.items()))

    def flush(buf):
        runs: dict = {}
        for it in buf:
            runs.setdefault(shape_of(it), []).append(it)
        for key in sorted(runs):
            run = runs[key]
            for i in range(0, len(run), k):
                yield run[i : i + k]

    buf: list = []
    for b in batches:
        buf.append(b)
        if len(buf) == window:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)


def batch_seeds(base: int, epoch: int, index: int):
    """Two independent 63-bit seeds for one batch: (noise generator, dropout)."""
    s = np.random.SeedSequence([base, epoch, index]).generate_state(2, np.uint64)
    return int(s[0] >> np.uint64(1)), int(s[1] >> np.uint64(1))


class MetricLogger:
    """`metrics.jsonl` in `log_dir`, and TensorBoard scalars under `log_dir/tb`
    when `torch.utils.tensorboard` imports."""

    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.jsonl"
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception:  # tensorboard is optional
                self.tb = None

    def log(self, step: int, metrics: dict, prefix: str = "", epoch: Optional[int] = None):
        row = {"step": step, "time": time.time()}
        if epoch is not None:
            row["epoch"] = int(epoch)
        for k, v in metrics.items():
            row[f"{prefix}{k}"] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(f"{prefix}{k}", float(v), step)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def close(self):
        if self.tb is not None:
            self.tb.close()


class Trainer:
    """Trains on one device (the CUDA card unless `device` says otherwise)."""

    def __init__(self, model_cfg: MatchaConfig = MatchaConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 data_cfg: DataConfig = DataConfig(), device=None):
        if train_cfg.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32 or bf16, got {train_cfg.precision}")
        for name, default in (("mas_impl", "auto"), ("profile_dir", None),
                              ("steps_per_dispatch", 1)):
            if getattr(train_cfg, name) != default:
                raise NotImplementedError(f"TrainConfig.{name} is not ported yet (ROADMAP)")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            apply_tf32_policy()
        self.model_cfg, self.train_cfg, self.data_cfg = model_cfg, train_cfg, data_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            self.model = MatchaTTS(model_cfg)
        self.model.to(self.device)
        self.params = [p for p in self.model.parameters()]
        self.optimizer: Optional[AccumulatingAdamW] = None
        self.checkpoints = CheckpointStore(train_cfg.ckpt_dir, train_cfg.keep_top_k)
        self.logger = MetricLogger(Path(train_cfg.ckpt_dir) / "logs")
        self._decoder_dtype = torch.bfloat16 if train_cfg.precision == "bf16" else None

    def init_optimizer(self, steps_per_epoch: int) -> AccumulatingAdamW:
        self.optimizer = make_optimizer(self.train_cfg, steps_per_epoch, self.params)
        return self.optimizer

    def _tensors(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in ("x", "x_lengths", "y", "y_lengths")}

    def _forked_rng(self):
        """The global generators (dropout's) restored on exit."""
        if self.device.type != "cuda":
            return torch.random.fork_rng(devices=[])
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        return torch.random.fork_rng(devices=[index])

    def train_step(self, batch: dict, epoch: int, index: int) -> dict:
        """One micro-step on the batch at schedule index `index` of `epoch`:
        losses, gradients, an optimizer step (an update every k-th call).
        Returns the metrics as 0-d tensors."""
        noise_seed, drop_seed = batch_seeds(self.train_cfg.seed + 1, epoch, index)
        b = self._tensors(batch)
        self.model.train()
        with self._forked_rng():
            torch.manual_seed(drop_seed)
            gen = torch.Generator(device=self.device).manual_seed(noise_seed)
            out = self.model.compute_losses(
                b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                out_size=self.train_cfg.out_size, decoder_dtype=self._decoder_dtype,
                generator=gen)
            losses = {k: out[k] for k in ("dur_loss", "prior_loss", "diff_loss")}
            loss = total_loss(losses)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        self.optimizer.step(grads)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = loss.detach()
        if self.train_cfg.log_grad_norm:
            metrics["grad_norm"] = global_norm(grads)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, epoch: int, index: int) -> dict:
        """Validation losses of one batch (dropout off, f32 U-Net), as 0-d tensors."""
        noise_seed, _ = batch_seeds(self.train_cfg.seed + 2, epoch, index)
        b = self._tensors(batch)
        self.model.eval()
        gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        out = self.model.compute_losses(b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                                        generator=gen)
        losses = {k: out[k] for k in ("dur_loss", "prior_loss", "diff_loss")}
        losses["loss"] = total_loss(losses)
        return losses

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, train_ds, val_ds, max_epochs: Optional[int] = None, resume: bool = True) -> int:
        """Train to `max_epochs`, resuming from the latest checkpoint; returns the
        micro-step count. Validates and checkpoints after every epoch (or every
        `ckpt_every_epochs`, the last one always)."""
        cfg = self.train_cfg
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        steps_per_epoch = max(num_batches(len(train_ds), self.data_cfg), 1)
        self.init_optimizer(steps_per_epoch)
        step, start_epoch = 0, 0
        if resume:
            restored = self.checkpoints.restore_latest(map_location=self.device)
            if restored is not None:
                state, step, start_epoch = restored
                self.model.load_state_dict(state["model"])
                self.optimizer.load_state_dict(state["optimizer"])
                print(f"resumed from step {step} (epoch {start_epoch})")

        for epoch in range(start_epoch, max_epochs):
            self._sync()
            t0 = time.perf_counter()
            for i, batch in enumerate(batch_iterator(train_ds, self.data_cfg, epoch=epoch)):
                batch.pop("n_real")
                metrics = self.train_step(batch, epoch, i)
                if step % cfg.log_every == 0:
                    self.logger.log(step, metrics, prefix="train/", epoch=epoch)
                step += 1
            self._sync()
            epoch_seconds = time.perf_counter() - t0

            val, weights = [], []
            for vi, batch in enumerate(batch_iterator(val_ds, self.data_cfg, epoch=0,
                                                      shuffle=False, drop_last=False)):
                weights.append(batch.pop("n_real"))
                val.append({k: float(v) for k, v in self.eval_step(batch, epoch, vi).items()})
            if val:
                w = np.asarray(weights, np.float64)
                agg = {k: float(np.average([m[k] for m in val], weights=w)) for k in val[0]}
            else:
                agg = {"loss": float("inf")}
            agg["epoch_seconds"] = epoch_seconds
            self.logger.log(step, agg, prefix="val/", epoch=epoch)
            if (epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch + 1 == max_epochs:
                self.checkpoints.save(step, epoch + 1, {"model": self.model.state_dict(),
                                                        "optimizer": self.optimizer.state_dict()},
                                      agg["loss"])
        self.logger.close()
        return step

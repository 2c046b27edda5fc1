"""HiFi-GAN vocoder training: the GAN step of generator and discriminators.

The port of `matcha_tpu/train/vocoder.py`, with the same recipe and
hyperparameters:

  disc step:  L_D = LSGAN(MPD) + LSGAN(MSD) on (y, y_hat detached)
  gen step:   L_G = LSGAN_adv(MPD + MSD) + 2 * L_FM(MPD + MSD)
              + 45 * L1(mel(y), mel(y_hat)), mel over the full band (fmax None)

The discriminators update first; the generator then updates against the
refreshed discriminators. The generator runs forward once a step: the JAX
step runs it twice with the same parameters, the second time inside the
generator's loss, which gives the same values. Its loss differentiates with
respect to the generator's parameters only. The generator is the weight-normed
training form (`models/hifigan.py`), f32 under `apply_tf32_policy`.

Optimizers: optax.adamw with optax's defaults (eps 1e-8, weight decay 1e-4 on
every parameter, biases and scales included) at lr * lr_decay^(count //
steps_per_epoch), `count` the updates before this one, one for each network
(`ScheduledAdamW`). The host keeps the counters and gives each step a row of
six scalars, the negated learning rate and both bias corrections of each
optimizer; the device reads the row and nothing goes back to the host but the
logged metrics.

Dispatch (`VocoderTrainConfig.steps_per_dispatch` = K): every batch has the
same shape, so `fit` groups the batches of an epoch into runs of K and runs an
epoch's remainder one step at a time. On the card a run of K replays one CUDA
graph of K steps and a remainder step the 1-step graph: two graphs, captured
at first use (`trainer._StepGraph`) after one eager run on a side stream
whose optimizer updates are undone, in one memory pool per trainer. The step
draws no randomness. A capture or replay failure raises. On CPU tensors the
same steps run eagerly. Validation (`validate`, the JAX trainer's jitted
eval) replays one more graph on the card, of a validation batch's mel L1,
captured at first use in the same way; the batches' L1 are summed on the
device and read once an epoch. On the CPU it runs eagerly.

Several ranks (`VocoderTrainer(mesh=...)`, `parallel/`): both networks are
replicated (rank 0's weights, broadcast), every rank reads the global batch
of each step (`batch_size` x the data ranks, the segment crops drawn for it
in order) and trains on its block of rows. Every loss is a mean over equal
blocks, so the mean of the ranks' gradients is the global batch's: each
gradient is summed over the data group and scaled by 1 / n inside the step
(and its CUDA graph), before its optimizer update. The logged metrics and
the validation L1 are the ranks' means. A world-n run at `batch_size` B
trains as a world-1 run at n B. Rank 0 writes the checkpoints and
`metrics.jsonl`, rank i > 0 `metrics_rank{i}.jsonl`.
"""

import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.audio.mel import MelConfig, mel_spectrogram
from matcha_tpu_torch.data.audio_dataset import AudioDataConfig, wav_batch_iterator
from matcha_tpu_torch.models.hifigan import (
    Generator,
    HiFiGANConfig,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    fold_weight_norm,
    generator_loss,
    norm_init_,
)
from matcha_tpu_torch.parallel.mesh import all_reduce_flat, is_main, replicated
from matcha_tpu_torch.train.checkpoints import CheckpointStore
from matcha_tpu_torch.train.trainer import (
    MetricLogger,
    _Eager,
    _StepGraph,
    adamw_,
    check_mesh_device,
    copy_out,
    flush_logs,
    host_tensor,
)

# a step's metrics, in the order of its (5,) output (the JAX step's dict)
METRICS = ("mel_l1", "fm", "adv", "d_loss", "g_loss")
WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX trainer keeps


@dataclass(frozen=True)
class VocoderTrainConfig:
    lr: float = 4e-4
    betas: tuple = (0.8, 0.99)
    lr_decay: float = 0.999  # per-epoch exponential decay
    mel_loss_weight: float = 45.0
    max_epochs: int = 100
    log_every: int = 10
    ckpt_dir: str = "checkpoints_vocoder"
    keep_top_k: int = 3
    seed: int = 1234
    # K GAN steps per dispatch (one CUDA graph replay on the card); the
    # trajectory does not depend on K
    steps_per_dispatch: int = 1
    ckpt_every_epochs: int = 1  # the final epoch is always saved


class Discriminators(nn.Module):
    """MPD and MSD in one module (keys `mpd.*`, `msd.*`). `mpd_channels` and
    `msd_spec` default to v1's sizes; tests shrink them."""

    def __init__(self, mpd_channels: Optional[tuple] = None, msd_spec: Optional[tuple] = None):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(
            **({} if mpd_channels is None else {"channels": mpd_channels}))
        self.msd = MultiScaleDiscriminator(**({} if msd_spec is None else {"spec": msd_spec}))

    def forward(self, y, y_hat):
        return self.mpd(y, y_hat), self.msd(y, y_hat)


class ScheduledAdamW:
    """optax.adamw(exponential_decay(lr, steps_per_epoch, lr_decay,
    staircase=True), b1, b2) on a parameter list, its counter on the host:
    `advance(n)` gives the next n updates' (n, WIDTH) rows (`NEG_LR` the
    negated learning rate, `BC1`, `BC2` the bias corrections) and counts them;
    `apply(grads, row)` runs one update on the device in place."""

    NEG_LR, BC1, BC2 = range(3)  # the columns of a row
    WIDTH = 3

    def __init__(self, params, cfg: VocoderTrainConfig, steps_per_epoch: int):
        self.params = list(params)
        self.cfg = cfg
        self.steps_per_epoch = max(steps_per_epoch, 1)
        self.count = 0  # updates made
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self, count: int) -> float:
        return self.cfg.lr * self.cfg.lr_decay ** (count // self.steps_per_epoch)

    def advance(self, n: int = 1) -> np.ndarray:
        b1, b2 = self.cfg.betas
        rows = np.zeros((n, self.WIDTH), np.float64)
        for r in rows:
            r[self.NEG_LR] = -self.lr(self.count)
            r[self.BC1], r[self.BC2] = 1 - b1 ** (self.count + 1), 1 - b2 ** (self.count + 1)
            self.count += 1
        return rows.astype(np.float32)

    def apply(self, grads, row: torch.Tensor) -> None:
        adamw_(self.params, list(grads), self.mu, self.nu, row[self.NEG_LR], row[self.BC1],
               row[self.BC2], self.cfg.betas, WEIGHT_DECAY)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in ("mu", "nu"):
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(src)


def make_optimizers(cfg: VocoderTrainConfig, steps_per_epoch: int, gen_params, disc_params):
    """(generator's, discriminators') optimizers."""
    return (ScheduledAdamW(gen_params, cfg, steps_per_epoch),
            ScheduledAdamW(disc_params, cfg, steps_per_epoch))


def make_vocoder_step(gen: Generator, disc: Discriminators, opt_g: ScheduledAdamW,
                      opt_d: ScheduledAdamW, cfg: VocoderTrainConfig, mel_cfg: MelConfig,
                      group=None):
    """The GAN step: (y (B, T) waveforms, row (2 * WIDTH,): the generator's
    optimizer row, then the discriminators') on the device -> (5,) metrics
    (`METRICS`). Updates both networks and their optimizers in place. With a
    data `group`, y is this rank's block of the global batch, and the
    gradients and metrics are the means over the group's ranks."""
    loss_mel_cfg = replace(mel_cfg, fmax=None)  # the loss mel covers the full band
    w = ScheduledAdamW.WIDTH
    scale = None if group is None else 1.0 / dist.get_world_size(group)

    def mean(tensors):
        return tensors if group is None else all_reduce_flat(tensors, group, scale)

    def step(y: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        y_hat = gen(mel_spectrogram(mel_cfg, y).transpose(1, 2))

        # the discriminators' update, on the generator's output detached
        (pr, pg, _, _), (sr, sg, _, _) = disc(y, y_hat.detach())
        d_loss = discriminator_loss(pr, pg)[0] + discriminator_loss(sr, sg)[0]
        opt_d.apply(mean(torch.autograd.grad(d_loss, opt_d.params)), row[w:])

        # the generator's update, against the refreshed discriminators
        (pr, pg, pfr, pfg), (sr, sg, sfr, sfg) = disc(y, y_hat)
        mel_l1 = torch.mean(torch.abs(mel_spectrogram(loss_mel_cfg, y)
                                      - mel_spectrogram(loss_mel_cfg, y_hat))) * cfg.mel_loss_weight
        fm = feature_loss(pfr, pfg) + feature_loss(sfr, sfg)
        adv = generator_loss(pg)[0] + generator_loss(sg)[0]
        g_loss = adv + fm + mel_l1
        opt_g.apply(mean(torch.autograd.grad(g_loss, opt_g.params)), row[:w])
        return mean([torch.stack([mel_l1, fm, adv, d_loss, g_loss]).detach()])[0]

    return step


def make_vocoder_eval(gen: Generator, mel_cfg: MelConfig):
    """Validation metric: the full-band mel L1 of resynthesised segments (0-d)."""
    loss_mel_cfg = replace(mel_cfg, fmax=None)

    @torch.no_grad()
    def eval_step(y: torch.Tensor) -> torch.Tensor:
        y_hat = gen(mel_spectrogram(mel_cfg, y).transpose(1, 2))
        return torch.mean(torch.abs(mel_spectrogram(loss_mel_cfg, y)
                                    - mel_spectrogram(loss_mel_cfg, y_hat)))

    return eval_step


def load_generator_for_inference(ckpt_dir, prefer: str = "best"):
    """The generator of a VocoderTrainer checkpoint, folded for serving: the
    best (or latest) checkpoint's weight-normed generator state dict with
    `weight_g`/`weight_v` folded into `weight`, for `Generator(cfg)` and
    `TTSEngine(vocoder_params=...)`. On the CPU."""
    params = CheckpointStore(ckpt_dir).restore_params(prefer, map_location="cpu")
    return fold_weight_norm(params["gen"])


class VocoderTrainer:
    """Trains HiFi-GAN on one device (the CUDA card unless `device` says
    otherwise), or as one rank of `mesh`'s data axis (`parallel.make_mesh`)."""

    def __init__(self, gen_cfg: HiFiGANConfig = HiFiGANConfig(),
                 train_cfg: VocoderTrainConfig = VocoderTrainConfig(),
                 data_cfg: AudioDataConfig = AudioDataConfig(), mel_cfg: MelConfig = MelConfig(),
                 disc: Optional[Discriminators] = None, device=None, mesh=None):
        hop = int(np.prod(gen_cfg.upsample_rates))
        if hop != mel_cfg.hop_size:
            raise ValueError(f"generator upsampling x{hop} must equal the mel hop "
                             f"{mel_cfg.hop_size}")
        if data_cfg.segment_size % hop:
            raise ValueError(f"segment_size {data_cfg.segment_size} is not a multiple of "
                             f"the hop {hop}")
        if train_cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {train_cfg.steps_per_dispatch}")
        self.device = resolve_device(device)
        check_mesh_device(mesh, self.device)
        if self.device.type == "cuda":
            apply_tf32_policy()
        self.gen_cfg, self.train_cfg, self.data_cfg, self.mel_cfg = (
            gen_cfg, train_cfg, data_cfg, mel_cfg)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            self.gen = Generator(gen_cfg, weight_norm=True)
            self.disc = Discriminators() if disc is None else norm_init_(disc)
        self.gen.to(self.device).train()
        self.disc.to(self.device).train()
        self.mesh = mesh
        self._rows = None if mesh is None else mesh.rows()  # this rank's rows
        if mesh is not None:
            replicated(self.gen)
            replicated(self.disc)
        self.opt_g: Optional[ScheduledAdamW] = None
        self.opt_d: Optional[ScheduledAdamW] = None
        self.checkpoints = CheckpointStore(train_cfg.ckpt_dir, train_cfg.keep_top_k)
        self._eval_local = make_vocoder_eval(self.gen, mel_cfg)
        # (K, segment shape) -> _StepGraph, on the card; all share one pool
        self.graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.replays: dict = {}  # K -> graph replays of K steps
        self.eager_steps = 0  # steps run eagerly (not counting a capture's warm-up)
        self.eval_graphs: dict = {}  # validation: segment shape -> _StepGraph, same pool
        self.eval_replays = 0

    def init_optimizers(self, steps_per_epoch: int):
        """Fresh optimizers; the graphs, which read the old ones' state by
        address, are dropped."""
        self.opt_g, self.opt_d = make_optimizers(self.train_cfg, steps_per_epoch,
                                                 self.gen.parameters(), self.disc.parameters())
        self._step = make_vocoder_step(self.gen, self.disc, self.opt_g, self.opt_d,
                                       self.train_cfg, self.mel_cfg,
                                       None if self._rows is None else self._rows.group)
        self.graphs.clear()
        return self.opt_g, self.opt_d

    def _steps(self, inputs: dict) -> torch.Tensor:
        """The steps of one dispatch on stacked device tensors, y (K, B, T) and
        rows (K, 6), in order: (K, 5) metrics."""
        return torch.stack([self._step(y, row) for y, row in zip(inputs["y"], inputs["rows"])])

    def _state(self) -> list:
        if self.opt_g is None:
            return list(self.gen.parameters()) + list(self.disc.parameters())
        return (self.opt_g.params + self.opt_d.params + self.opt_g.mu + self.opt_g.nu
                + self.opt_d.mu + self.opt_d.nu)

    @torch.no_grad()
    def _snapshot(self) -> list:
        return [t.clone() for t in self._state()]

    @torch.no_grad()
    def _restore(self, saved: list) -> None:
        for dst, src in zip(self._state(), saved):
            dst.copy_(src)

    def dispatch(self, batches, eager: bool = False) -> torch.Tensor:
        """Run one GAN step on each (B, T) array of `batches`, in one dispatch: on
        the card one replay of the graph of K = len(batches) steps (captured at
        first use), unless `eager`; on the CPU eagerly. Returns the (K, 5)
        metrics on the device, valid until the next dispatch."""
        k = len(batches)
        rows = np.concatenate([self.opt_g.advance(k), self.opt_d.advance(k)], axis=1)
        host = {"y": host_tensor(np.stack(batches), self.device),
                "rows": host_tensor(rows, self.device)}
        if eager or self._pool is None:  # no graph pool on the CPU
            runner = _Eager(self.device, self._steps)
            self.eager_steps += k
        else:
            key = (k,) + tuple(host["y"].shape[1:])
            runner = self.graphs.get(key)
            if runner is None:
                runner = self.graphs[key] = _StepGraph(self, host, self._steps)
            self.replays[k] = self.replays.get(k, 0) + 1
        return runner.run(host)

    def eval_step(self, y: torch.Tensor) -> torch.Tensor:
        """The full-band mel L1 of resynthesised segments y (0-d): with a mesh,
        of the global batch whose block of rows y is."""
        val = self._eval_local(y)
        if self._rows is None:
            return val
        return all_reduce_flat([val], self._rows.group, 1.0 / self._rows.count)[0]

    def _batches(self, ds, **kw):
        """The batches `wav_batch_iterator` gives; with a mesh, this rank's
        block of rows of each global batch (crops drawn for the whole batch)."""
        if self._rows is None:
            yield from wav_batch_iterator(ds, self.data_cfg, **kw)
            return
        b, (i, n) = self.data_cfg.batch_size, (self._rows.index, self._rows.count)
        for y in wav_batch_iterator(ds, replace(self.data_cfg, batch_size=b * n), **kw):
            yield np.ascontiguousarray(y[i * b: (i + 1) * b])

    def eval_dispatch(self, y: np.ndarray, eager: bool = False) -> torch.Tensor:
        """`eval_step` of the (B, T) segments y, 0-d on the device: on the
        card a replay of the graph of y's shape (captured at first use),
        unless `eager`; on the CPU eagerly. Valid until the next dispatch."""
        host = {"y": host_tensor(y, self.device)}
        if eager or self._pool is None:  # no graph pool on the CPU
            runner = _Eager(self.device, self._eval_inputs)
        else:
            runner = self.eval_graphs.get(y.shape)
            if runner is None:
                runner = self.eval_graphs[y.shape] = _StepGraph(self, host, self._eval_inputs)
            self.eval_replays += 1
        return runner.run(host)

    def _eval_inputs(self, inputs: dict) -> torch.Tensor:
        return self.eval_step(inputs["y"])

    def validate(self, val_ds, eager: bool = False) -> float:
        """The mean over validation batches of `eval_step` (inf without data),
        each batch through `eval_dispatch`, summed on the device (float64) and
        read once."""
        total, n = None, 0
        if val_ds is not None and len(val_ds):
            for y in self._batches(val_ds, epoch=0, shuffle=False, drop_last=False):
                val = self.eval_dispatch(y, eager).double()
                total = val if total is None else total.add_(val)
                n += 1
        return float(total) / n if n else float("inf")

    def fit(self, train_ds, val_ds=None, max_epochs: Optional[int] = None,
            resume: bool = True) -> int:
        """Train to `max_epochs`, resuming from the latest checkpoint; returns the
        step count. Validates after every epoch and checkpoints every
        `ckpt_every_epochs` (the last epoch always)."""
        cfg = self.train_cfg
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        ranks = 1 if self._rows is None else self._rows.count
        steps_per_epoch = max(len(train_ds) // (self.data_cfg.batch_size * ranks), 1)
        self.init_optimizers(steps_per_epoch)
        step, start_epoch = 0, 0
        if resume:
            restored = self.checkpoints.restore_latest(map_location=self.device)
            if restored is not None:
                state, step, start_epoch = restored
                self.gen.load_state_dict(state["model"]["gen"])
                self.disc.load_state_dict(state["model"]["disc"])
                self.opt_g.load_state_dict(state["optimizer"]["gen"])
                self.opt_d.load_state_dict(state["optimizer"]["disc"])
                print(f"resumed vocoder training from step {step} (epoch {start_epoch})")

        logger = MetricLogger(Path(cfg.ckpt_dir) / "logs")
        pending: list = []  # metric rows on their way to the host

        def log_row(step, row, epoch):
            logger.log(step, dict(zip(METRICS, row)), prefix="train/", epoch=epoch)

        def run(group, epoch):
            nonlocal step
            out = self.dispatch(group)
            if any((step + i) % cfg.log_every == 0 for i in range(len(group))):
                pending.append((step, epoch, *copy_out(out)))
            step += len(group)
            flush_logs(pending, False, cfg.log_every, log_row)

        try:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.perf_counter()
                buf = []  # runs of K through the K-step graph
                for y in self._batches(train_ds, epoch=epoch):
                    buf.append(y)
                    if len(buf) == cfg.steps_per_dispatch:
                        run(buf, epoch)
                        buf = []
                for y in buf:  # the epoch's remainder, one step at a time
                    run([y], epoch)
                flush_logs(pending, True, cfg.log_every, log_row)
                val_loss = self.validate(val_ds)
                logger.log(step, {"mel_l1": val_loss, "epoch_seconds": time.perf_counter() - t0},
                           prefix="val/", epoch=epoch)
                save = (epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch + 1 == max_epochs
                if save and is_main():
                    self.checkpoints.save(
                        step, epoch + 1,
                        {"model": {"gen": self.gen.state_dict(), "disc": self.disc.state_dict()},
                         "optimizer": {"gen": self.opt_g.state_dict(),
                                       "disc": self.opt_d.state_dict()}},
                        val_loss)
                if save and self.mesh is not None:  # the checkpoint is on disk for every rank
                    dist.barrier()
        finally:
            logger.close()
        return step

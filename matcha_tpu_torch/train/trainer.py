"""Training loop: optimizer, train and validation steps, metrics, checkpoints.

The port of `matcha_tpu/train/trainer.py`, with the same hyperparameters:

  * AdamW, lr 1e-4, betas (0.9, 0.999), weight decay 1e-6, per-epoch cosine
    annealing to 1e-6 over 1000 epochs;
  * global-norm clipping at 1.0 and 2-step gradient accumulation;
  * loss = duration + prior + flow matching; `precision="bf16"` runs the U-Net
    on a bf16 view of f32 master weights (`models/precision.py`);
  * checkpoints: top-k on validation loss plus the latest, auto-resume;
  * metrics to JSONL, TensorBoard scalars and validation images when it imports.

The optimizer reproduces the JAX package's optax chain,
MultiSteps(chain(clip_by_global_norm, adamw)), update for update:
  * clipping is optax's: g where ||g|| < max, else g / ||g|| * max (no epsilon);
  * the accumulator is a running mean, acc + (g - acc) / (i + 1), and the
    parameters do not move on the steps that emit no update;
  * the learning-rate schedule counts emitted updates, not micro-steps, and
    takes micro-steps per epoch as its epoch length, as the JAX trainer feeds
    it: with accumulation 2 its epoch index advances at half the data's rate.
The host keeps its counters (`AccumulatingAdamW.advance`): it knows which
micro-steps emit an update, and writes each micro-step's learning rate, bias
corrections and running-mean divisor into a row of scalars that the device
reads. The logged grad_norm is the norm of each micro-step's gradient before
clipping.

Dispatch (`TrainConfig.steps_per_dispatch` = K, the JAX trainer's
`make_train_steps_scan`): `fit` groups the batch stream into runs of K
same-shape batches (`chunk_batches_by_shape`, an order that does not depend
on K). On the card a full group replays one CUDA graph of K micro-steps and
a remainder replays the 1-step graph of its shape, K = 1 included; a graph
is captured at the first use of its key, (K, which of the K micro-steps
emit an update, batch shapes): at most `accumulate_steps` emit patterns a
shape, as `lax.cond` in the JAX trainer's scan runs one branch. A capture
or replay failure raises. On CPU tensors the same micro-steps run eagerly.
A micro-step is a function of static tensors only: the stacked batch, its
scalar row and two generators per slot of the dispatch, which a graph
registers and the host seeds before each replay. It updates the parameters
and the optimizer's state in place and reads nothing back to the host.

Randomness of the batch at schedule index i of epoch e (CFM t and z, crop
offsets, dropout) comes from generators seeded by (seed + 1, e, i), and of
validation batch i by (seed + 2, e, i): a run's trajectory depends neither
on where it was resumed nor on K.

Several ranks (`Trainer(mesh=...)`, `parallel/`): every rank builds the model
from the seed and takes rank 0's weights (a broadcast); each loads its
`[index::count]` cut of every global batch (its data index and count), draws
the noise and dropout of the global batch and keeps its rows, and divides its
losses by the global batch's normalisers, so that the gradients summed over
the data group (one all-reduce a micro-step, inside the micro-step and so
inside its CUDA graph) are the global batch's, and so are the logged losses
and grad_norm. A mesh with a `model` axis also shards the Megatron pairs
(`parallel.TensorParallel`); the grad norm then sums the squares of the
blocks over the model group. Rank 0 writes `metrics.jsonl`, TensorBoard, the
checkpoints (the gathered, full state) and the validation images; rank i > 0
writes `metrics_rank{i}.jsonl`. Validation losses are global, so every rank
ranks checkpoints alike.
"""

import functools
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.data.dataset import DataConfig, batch_iterator, num_batches
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.nn.dropout import dropout_generator
from matcha_tpu_torch.ops.attention import attention, attention_backward
from matcha_tpu_torch.ops.mas import mas_cuda
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_flat,
    batch_rows,
    batch_sum,
    is_main,
    put_global_batch,
    rank,
    replicated,
)
from matcha_tpu_torch.parallel.sharding import TensorParallel
from matcha_tpu_torch.train.checkpoints import CheckpointStore
from matcha_tpu_torch.utils.profiling import StepTimer, start_trace, stop_trace

# the kernel wrappers whose launches a training graph records at capture
COUNTED = {"attention_fwd": attention, "attention_bwd": attention_backward, "mas": mas_cuda}
BATCH_KEYS = ("x", "x_lengths", "y", "y_lengths")
# a micro-step's metrics, in the order of its (5,) output
METRICS = ("dur_loss", "prior_loss", "diff_loss", "loss", "grad_norm")
# MAS implementations: the port has one (the fused kernel on CUDA tensors, the
# plain version on CPU ones); "ref" names the plain one and is the CPU's
MAS_IMPLS = ("auto", "pallas", "ref")


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
    # "auto" or "pallas": the fused kernel on the card, the plain version on
    # the CPU; "ref": the plain version, on the CPU only
    mas_impl: str = "auto"
    log_grad_norm: bool = True
    precision: str = "fp32"  # or "bf16": bf16 U-Net on f32 master weights
    # trace dispatches 2-3 of each fit() into this directory (torch.profiler)
    profile_dir: Optional[str] = None
    # train the decoder on a random window of this many frames per sample
    out_size: Optional[int] = None
    ckpt_every_epochs: int = 1
    # K micro-steps per dispatch (one CUDA graph replay on the card); a pure
    # performance knob: the trajectory does not depend on K
    steps_per_dispatch: int = 1


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


@torch.no_grad()
def adamw_(params, grads, mu, nu, neg_lr, bc1, bc2, betas, weight_decay) -> None:
    """One AdamW update in place, as optax's adamw (eps 1e-8 outside the square
    root, decay on the parameters before the update), from the negated
    learning rate and the bias corrections 1 - b^count (0-d device tensors)."""
    b1, b2 = betas
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, 1e-8)
    update = torch._foreach_div(mu, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(update, params, alpha=weight_decay)
    torch._foreach_mul_(update, neg_lr)
    torch._foreach_add_(params, update)


class AccumulatingAdamW:
    """optax.MultiSteps(chain(clip_by_global_norm, adamw(schedule)), k) on a parameter list.

    The host keeps the counters (`mini_step`, `count`); `advance(n)` returns
    the next n micro-steps' scalar rows and whether each emits an update, and
    moves the counters past them. `apply(grads, row, emit)` runs one
    micro-step on the device from its row (`DIV` the running mean's divisor,
    `NEG_LR` the negated learning rate, `BC1`, `BC2` the bias corrections of
    the update): the accumulator always, the update where `emit`. It updates
    the state in place, as multi-tensor (`torch._foreach_*`) operations, and
    reads nothing back to the host. `step(grads)` is one micro-step of both.
    """

    DIV, NEG_LR, BC1, BC2 = range(4)  # the columns of a row
    WIDTH = 4

    def __init__(self, params, cfg: TrainConfig, steps_per_epoch: int, norm=global_norm):
        self.params = list(params)
        self.cfg = cfg
        self.norm = norm  # the global norm of a gradient list (tensor parallelism's own)
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.mini_step = 0
        self.count = 0  # emitted updates
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def advance(self, n: int = 1):
        """((n, WIDTH) float32 rows, n emit flags) of the next n micro-steps;
        moves the counters."""
        b1, b2 = self.cfg.betas
        rows = np.zeros((n, self.WIDTH), np.float64)
        emits = []
        for r in rows:
            emit = self.mini_step + 1 >= self.cfg.accumulate_steps
            r[self.DIV] = self.mini_step + 1
            # the learning rate and bias corrections of the update this accumulation emits
            r[self.NEG_LR] = -self.schedule(self.count)
            r[self.BC1], r[self.BC2] = 1 - b1 ** (self.count + 1), 1 - b2 ** (self.count + 1)
            emits.append(emit)
            if emit:
                self.count += 1
                self.mini_step = 0
            else:
                self.mini_step += 1
        return rows.astype(np.float32), tuple(emits)

    @torch.no_grad()
    def apply(self, grads, row: torch.Tensor, emit: bool) -> None:
        """One micro-step from `row` (WIDTH,), a tensor on the parameters' device."""
        cfg = self.cfg
        delta = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(delta, row[self.DIV])
        torch._foreach_add_(self.acc, delta)  # acc + (g - acc) / (i + 1)
        if not emit:
            return
        norm = self.norm(self.acc)
        clip = torch.where(norm < cfg.grad_clip, torch.ones_like(norm), cfg.grad_clip / norm)
        adamw_(self.params, torch._foreach_mul(self.acc, clip), self.mu, self.nu,
               row[self.NEG_LR], row[self.BC1], row[self.BC2], cfg.betas, cfg.weight_decay)
        torch._foreach_zero_(self.acc)

    def step(self, grads) -> bool:
        """One micro-step; returns whether it emitted an update."""
        rows, (emit,) = self.advance(1)
        self.apply(grads, torch.from_numpy(rows[0]).to(self.params[0].device), emit)
        return emit

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "count": self.count,
                "acc": self.acc, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step, self.count = int(state["mini_step"]), int(state["count"])
        for name in ("acc", "mu", "nu"):
            for dst, src in zip(getattr(self, name), state[name]):
                dst.copy_(src)


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, params,
                   norm=global_norm) -> AccumulatingAdamW:
    return AccumulatingAdamW(params, cfg, steps_per_epoch, norm)


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


def _tb_importable() -> bool:
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
    except Exception:  # tensorboard is optional: any import failure means absent
        return False
    return True


class MetricLogger:
    """`metrics.jsonl` in `log_dir`, and TensorBoard under `log_dir/tb` when
    `torch.utils.tensorboard` imports (`tb_available`, an import probe that
    gates the validation images, the same on every rank). Several ranks:
    rank 0 owns `metrics.jsonl` and TensorBoard, rank i > 0 writes
    `metrics_rank{i}.jsonl`."""

    def __init__(self, log_dir, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        r = rank()
        self.path = self.log_dir / ("metrics.jsonl" if r == 0 else f"metrics_rank{r}.jsonl")
        self.tb_available = use_tensorboard and _tb_importable()
        self.tb = None
        if self.tb_available and r == 0:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(str(self.log_dir / "tb"))

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


class _Slot:
    """The generators of one micro-step of a dispatch: CFM noise and crop
    offsets, and dropout."""

    def __init__(self, device):
        self.noise = torch.Generator(device=device)
        self.dropout = torch.Generator(device=device)

    def seed(self, seeds) -> None:
        self.noise.manual_seed(seeds[0])
        self.dropout.manual_seed(seeds[1])


def _launch_counts() -> dict:
    return {name: w.launches for name, w in COUNTED.items()}


class _Eager:
    """Steps run eagerly: on CPU tensors, and `train_step` on the card."""

    launches = {}

    def __init__(self, device, fn):
        self.device, self.fn = device, fn

    def run(self, host: dict):
        return self.fn({n: h.to(self.device, non_blocking=True) for n, h in host.items()})


class _StepGraph:
    """K training steps, `fn` on a dict of stacked (K, ...) device tensors, captured
    as one CUDA graph at fixed shapes.

    The inputs (`host`'s arrays: the stacked batches and the (K, width) scalar
    "rows") are static buffers allocated outside `owner`'s pool; `run` copies
    the host's pinned arrays into them and replays. The outputs live in the
    shared pool: read them before any other replay. Before the capture one
    eager run on a side stream builds what is built at first use (kernels,
    cuBLAS and cuDNN state, cuFFT plans); its optimizer steps are real, so the
    owner's state is snapshotted before it and restored after it (the capture
    itself runs nothing). `generators` are registered with the graph, which
    replays draw from. `launches` holds the kernel launches the capture
    recorded, which each replay repeats; `warmup_launches` those of the eager
    run.
    """

    def __init__(self, owner, host: dict, fn, generators=()):
        dev = owner.device
        self.k = host["rows"].shape[0]
        self.inputs = {n: torch.empty(h.shape, dtype=h.dtype, device=dev) for n, h in host.items()}
        self._copy_in(host)
        saved = owner._snapshot()
        before = _launch_counts()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmup_launches = {n: c - before[n] for n, c in _launch_counts().items()}
        owner._restore(saved)
        del saved
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = _launch_counts()
        with torch.cuda.graph(self.graph, pool=owner._pool, capture_error_mode="thread_local"):
            self.outputs = fn(self.inputs)
        self.launches = {n: c - before[n] for n, c in _launch_counts().items()}
        self.capture_s = time.perf_counter() - t0

    def _copy_in(self, host: dict) -> None:
        for n, dst in self.inputs.items():
            dst.copy_(host[n], non_blocking=True)

    def run(self, host: dict):
        self._copy_in(host)
        self.graph.replay()
        return self.outputs


def host_tensor(a: np.ndarray, device) -> torch.Tensor:
    """`a` as a tensor for a copy to `device`: pinned when that is a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def flush_logs(pending: list, wait: bool, log_every: int, log_row) -> None:
    """Log the metric rows of `pending` [(first step, epoch, host rows, event)]
    whose copies have landed (all of them with `wait`), in order:
    `log_row(step, row, epoch)` for each step `log_every` picks."""
    while pending and (wait or pending[0][3] is None or pending[0][3].query()):
        first, epoch, rows, done = pending.pop(0)
        if done is not None:
            done.synchronize()
        for i, r in enumerate(rows.tolist()):
            if (first + i) % log_every == 0:
                log_row(first + i, r, epoch)


def copy_out(out: torch.Tensor):
    """(host copy of `out`, CUDA event after the copy, or None on the CPU)."""
    if out.device.type != "cuda":
        return out.clone(), None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def check_mesh_device(mesh, device: torch.device) -> None:
    """Raise unless `mesh`'s ranks run on `device`'s kind: NCCL on the card,
    gloo on the CPU."""
    if mesh is not None and mesh.device.type != device.type:
        raise ValueError(f"a mesh of {mesh.device.type} ranks cannot train on {device}")


class Trainer:
    """Trains on one device (the CUDA card unless `device` says otherwise), or
    as one rank of `mesh` (`parallel.make_mesh`)."""

    def __init__(self, model_cfg: MatchaConfig = MatchaConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 data_cfg: DataConfig = DataConfig(), device=None, mesh=None):
        if train_cfg.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be fp32 or bf16, got {train_cfg.precision}")
        if train_cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {train_cfg.steps_per_dispatch}")
        self.device = resolve_device(device)
        check_mesh_device(mesh, self.device)
        if train_cfg.mas_impl not in MAS_IMPLS or (
                train_cfg.mas_impl == "ref" and self.device.type != "cpu"):
            raise ValueError(f"mas_impl {train_cfg.mas_impl!r} on {self.device.type}: the port "
                             f"has one MAS; accepted are 'auto' and 'pallas' (the fused kernel "
                             f"on the card, the plain version on the CPU) and, on the CPU, 'ref'")
        if self.device.type == "cuda":
            apply_tf32_policy()
        self.model_cfg, self.train_cfg, self.data_cfg = model_cfg, train_cfg, data_cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            self.model = MatchaTTS(model_cfg)
        self.model.to(self.device)
        self.mesh = mesh
        self._rows = None  # this rank's rows of the global batch
        self._tp: Optional[TensorParallel] = None
        if mesh is not None:
            replicated(self.model)
            self._rows = mesh.rows()
            if MODEL_AXIS in mesh.axes:
                self._tp = TensorParallel(self.model, mesh)
                self._tp.shard()
        self._norm = global_norm if self._tp is None else self._tp.norm
        self.params = [p for p in self.model.parameters()]
        self.optimizer: Optional[AccumulatingAdamW] = None
        self.checkpoints = CheckpointStore(train_cfg.ckpt_dir, train_cfg.keep_top_k)
        self.logger = MetricLogger(Path(train_cfg.ckpt_dir) / "logs")
        self._decoder_dtype = torch.bfloat16 if train_cfg.precision == "bf16" else None
        self._slots: list = []
        # (K, emit pattern, batch shapes) -> _StepGraph, on the card; all share one pool
        self.graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # kernel launches made by this trainer's graph replays, by kernel
        self.launches = {name: 0 for name in COUNTED}
        self.replays: dict = {}  # K -> graph replays of K micro-steps

    def init_optimizer(self, steps_per_epoch: int) -> AccumulatingAdamW:
        """A fresh optimizer; the graphs, which read the old one's state by
        address, are dropped."""
        self.optimizer = make_optimizer(self.train_cfg, steps_per_epoch, self.params,
                                        self._norm)
        self.graphs.clear()
        return self.optimizer

    # ----------------------------------------------------------- micro-steps
    def _losses_and_grads(self, b: dict, slot: _Slot):
        """The (4,) losses (`METRICS` but grad_norm) and the gradients of the
        batch `b` (device tensors) with its slot's generators: the global
        batch's, summed over the data group, under a mesh."""
        self.model.train()
        with dropout_generator(slot.dropout), batch_rows(self._rows):
            out = self.model.compute_losses(
                b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                out_size=self.train_cfg.out_size, decoder_dtype=self._decoder_dtype,
                generator=slot.noise)
            losses = {k: out[k] for k in ("dur_loss", "prior_loss", "diff_loss")}
            loss = total_loss(losses)
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
            metrics = torch.stack([*losses.values(), loss])
            if self._rows is not None:
                grads = all_reduce_flat(grads, self._rows.group)
                metrics = batch_sum(metrics)
        return metrics.detach(), grads

    def _micro_step(self, b: dict, row: torch.Tensor, slot: _Slot, emit: bool) -> torch.Tensor:
        """Losses, gradients and an optimizer micro-step on device tensors:
        the batch `b`, its scalar row and its slot's generators; `emit`: it
        ends an accumulation. Returns the (5,) metrics (`METRICS`); grad_norm
        is 0 unless logged."""
        metrics, grads = self._losses_and_grads(b, slot)
        norm = (self._norm(grads) if self.train_cfg.log_grad_norm
                else torch.zeros((), device=metrics.device))
        self.optimizer.apply(grads, row, emit)
        return torch.cat([metrics, norm[None]]).detach()

    def _steps(self, inputs: dict, slots, emits) -> torch.Tensor:
        """The micro-steps of one dispatch on stacked (K, ...) device tensors
        (`BATCH_KEYS` and "rows"), in order: (K, 5) metrics."""
        return torch.stack([
            self._micro_step({n: inputs[n][i] for n in BATCH_KEYS}, inputs["rows"][i], slot, emit)
            for i, (slot, emit) in enumerate(zip(slots, emits))])

    def _state(self) -> list:
        opt = self.optimizer
        return self.params + opt.acc + opt.mu + opt.nu

    @torch.no_grad()
    def _snapshot(self) -> list:
        return [t.clone() for t in self._state()]

    @torch.no_grad()
    def _restore(self, saved: list) -> None:
        for dst, src in zip(self._state(), saved):
            dst.copy_(src)

    def dispatch(self, chunk, epoch: int, eager: bool = False) -> torch.Tensor:
        """Run the micro-steps of `chunk`, a list of (batch, schedule index)
        of one batch shape, in one dispatch: on the card one replay of the
        CUDA graph of its key (K, which micro-steps emit an update, batch
        shapes; captured at first use), unless `eager`; on the CPU eagerly.
        Returns the (K, 5) metrics on the device, valid until the next
        dispatch."""
        k = len(chunk)
        host = {n: host_tensor(np.stack([b[n] for b, _ in chunk]), self.device)
                for n in BATCH_KEYS}
        rows, emits = self.optimizer.advance(k)
        host["rows"] = host_tensor(rows, self.device)
        while len(self._slots) < k:
            self._slots.append(_Slot(self.device))
        slots = self._slots[:k]
        fn = functools.partial(self._steps, slots=slots, emits=emits)
        if eager or self._pool is None:  # no graph pool on the CPU
            runner = _Eager(self.device, fn)
        else:
            key = (k, emits) + tuple(tuple(host[n].shape[1:]) for n in BATCH_KEYS)
            runner = self.graphs.get(key)
            if runner is None:
                runner = self.graphs[key] = _StepGraph(
                    self, host, fn, [g for slot in slots for g in (slot.noise, slot.dropout)])
            self.replays[k] = self.replays.get(k, 0) + 1
        for slot, (_, index) in zip(slots, chunk):
            slot.seed(batch_seeds(self.train_cfg.seed + 1, epoch, index))
        out = runner.run(host)
        for name, n in runner.launches.items():
            self.launches[name] += n
        return out

    def train_step(self, batch: dict, epoch: int, index: int) -> dict:
        """One eager micro-step on the batch at schedule index `index` of
        `epoch`: losses, gradients, an optimizer step (an update every k-th
        call). Returns the metrics as 0-d tensors."""
        return self._named(self.dispatch([(batch, index)], epoch, eager=True)[0])

    def _named(self, row) -> dict:
        """A (5,) metrics row as {name: value}, grad_norm only when logged."""
        return {k: v for k, v in zip(METRICS, row)
                if k != "grad_norm" or self.train_cfg.log_grad_norm}

    @torch.no_grad()
    def eval_step(self, batch: dict, epoch: int, index: int) -> dict:
        """Validation losses of one batch (dropout off, f32 U-Net), as 0-d tensors."""
        noise_seed, _ = batch_seeds(self.train_cfg.seed + 2, epoch, index)
        b = put_global_batch(self.mesh, {k: batch[k] for k in BATCH_KEYS}, self.device)
        self.model.eval()
        gen = torch.Generator(device=self.device).manual_seed(noise_seed)
        names = ("dur_loss", "prior_loss", "diff_loss")
        with batch_rows(self._rows):
            out = self.model.compute_losses(b["x"], b["x_lengths"], b["y"], b["y_lengths"],
                                            generator=gen)
            values = batch_sum(torch.stack([out[k] for k in names]))
        losses = dict(zip(names, values))
        losses["loss"] = total_loss(losses)
        return losses

    # ------------------------------------------------------------------ fit
    def _data_shard(self) -> dict:
        """This rank's cut of the data: its index and the count of data ranks."""
        if self._rows is None:
            return {}
        return {"process_index": self._rows.index, "process_count": self._rows.count}

    def _full_state(self) -> dict:
        """The model's and the optimizer's state, whole (tensor-parallel blocks
        gathered: a collective on the model group)."""
        model, opt = self.model.state_dict(), self.optimizer.state_dict()
        if self._tp is not None:
            model = self._tp.state_dict()
            opt = dict(opt, **{k: self._tp.gather(opt[k]) for k in ("acc", "mu", "nu")})
        return {"model": model, "optimizer": opt}

    def _load_full_state(self, state: dict) -> None:
        opt = state["optimizer"]
        if self._tp is None:
            self.model.load_state_dict(state["model"])
        else:
            self._tp.load_state_dict(state["model"])
            opt = dict(opt, **{k: self._tp.blocks(opt[k]) for k in ("acc", "mu", "nu")})
        self.optimizer.load_state_dict(opt)

    def _flush_logs(self, pending: list, wait: bool) -> None:
        flush_logs(pending, wait, self.train_cfg.log_every,
                   lambda step, row, epoch: self.logger.log(step, self._named(row),
                                                            prefix="train/", epoch=epoch))

    def fit(self, train_ds, val_ds, max_epochs: Optional[int] = None, resume: bool = True) -> int:
        """Train to `max_epochs`, resuming from the latest checkpoint; returns the
        micro-step count. Validates and checkpoints after every epoch (or every
        `ckpt_every_epochs`, the last one always)."""
        cfg = self.train_cfg
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        shard = self._data_shard()
        steps_per_epoch = max(num_batches(len(train_ds), self.data_cfg,
                                          shard.get("process_count", 1)), 1)
        self.init_optimizer(steps_per_epoch)
        step, start_epoch = 0, 0
        if resume:
            restored = self.checkpoints.restore_latest(map_location=self.device)
            if restored is not None:
                state, step, start_epoch = restored
                self._load_full_state(state)
                print(f"resumed from step {step} (epoch {start_epoch})")

        k_max = cfg.steps_per_dispatch
        epoch_timer = StepTimer()
        dispatches = 0  # dispatches of this fit() call: the trace covers the 3rd and 4th
        profiler = None
        pending: list = []  # metric rows on their way to the host
        try:
            for epoch in range(start_epoch, max_epochs):
                pairs = (({k: v for k, v in b.items() if k != "n_real"}, i) for i, b in
                         enumerate(batch_iterator(train_ds, self.data_cfg, epoch=epoch,
                                                  **shard)))
                with epoch_timer.measure() as epoch_out:
                    for chunk in chunk_batches_by_shape(pairs, k_max):
                        # a full group replays its K-step graph; a remainder, its
                        # micro-steps through the 1-step graph of their shape
                        for group in [chunk] if len(chunk) == k_max else [[c] for c in chunk]:
                            if cfg.profile_dir is not None and dispatches == 2 and profiler is None:
                                profiler = start_trace(self.device)
                            out = self.dispatch(group, epoch)
                            if any((step + i) % cfg.log_every == 0 for i in range(len(group))):
                                pending.append((step, epoch, *copy_out(out)))
                            epoch_out["result"] = out
                            dispatches += 1
                            step += len(group)
                            if profiler is not None and dispatches == 4:
                                stop_trace(profiler, cfg.profile_dir, self.device)
                                profiler = None
                            self._flush_logs(pending, wait=False)
                self._flush_logs(pending, wait=True)
                agg = self._validate(val_ds, epoch, step, epoch_timer.times[-1])
                self._maybe_render_validation(val_ds, epoch, step, max_epochs)
                if (epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch + 1 == max_epochs:
                    state = self._full_state()
                    if is_main():
                        self.checkpoints.save(step, epoch + 1, state, agg["loss"])
                    if self.mesh is not None:  # the checkpoint is on disk for every rank
                        dist.barrier()
        finally:
            if profiler is not None:  # the run ended before the 4th dispatch
                stop_trace(profiler, cfg.profile_dir, self.device)
            self.logger.close()
        return step

    def _validate(self, val_ds, epoch: int, step: int, epoch_seconds: float) -> dict:
        """Validation losses of the epoch, each batch weighted by its distinct
        items, logged with the epoch's training seconds."""
        val, weights = [], []
        for vi, batch in enumerate(batch_iterator(val_ds, self.data_cfg, epoch=0, shuffle=False,
                                                  drop_last=False, **self._data_shard())):
            weights.append(batch.pop("n_real"))
            val.append({k: float(v) for k, v in self.eval_step(batch, epoch, vi).items()})
        if val:
            w = np.asarray(weights, np.float64)
            agg = {k: float(np.average([m[k] for m in val], weights=w)) for k in val[0]}
        else:
            agg = {"loss": float("inf")}
        agg["epoch_seconds"] = epoch_seconds
        self.logger.log(step, agg, prefix="val/", epoch=epoch)
        return agg

    def _maybe_render_validation(self, val_ds, epoch: int, step: int, max_epochs: int) -> bool:
        """Validation images to TensorBoard, on the checkpoint cadence
        (`ckpt_every_epochs`, the last epoch always), when TensorBoard imports
        (`logger.tb_available`). Returns whether the render path ran."""
        cfg = self.train_cfg
        if not self.logger.tb_available or len(val_ds) == 0:
            return False
        if not ((epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch + 1 == max_epochs):
            return False
        self._log_validation_images(val_ds, epoch, step)
        return True

    def _log_validation_images(self, val_ds, epoch: int, step: int, n_samples: int = 2):
        """Encoder output, decoder output (10 Euler steps, noise seeded by the
        epoch) and alignment of the first validation items as TensorBoard
        images, and the target mel at epoch 0. Rank 0 writes them; under
        tensor parallelism its model group decodes with it. A failure is
        printed: rendering never stops training."""
        decodes = self.logger.tb is not None or (
            self._tp is not None and self.mesh.index(DATA_AXIS) == 0)
        if not decodes or len(val_ds) == 0:
            return
        try:
            import matplotlib  # noqa: F401  (absent: nothing to render, so no decode)

            from matcha_tpu_torch.utils.plotting import plot_tensor

            self.model.eval()
            tb = self.logger.tb
            for i in range(min(n_samples, len(val_ds))):
                item = val_ds.get(i)
                x = torch.as_tensor(item["x"], dtype=torch.int64, device=self.device)[None, :]
                xl = torch.tensor([x.shape[1]], device=self.device)
                if epoch == 0 and tb is not None:
                    tb.add_image(f"original/{i}", plot_tensor(item["y"].T), epoch,
                                 dataformats="HWC")
                mu_x, w_ceil, x_mask, y_len = self.model.encode_durations(x, xl)
                budget = min(fix_len_compatibility(max(int(y_len.max()), 4)),
                             self.data_cfg.max_mel_len)
                gen = torch.Generator(device=self.device).manual_seed(epoch)
                out = self.model.decode_fixed(mu_x, w_ceil, x_mask, y_len, budget, 10,
                                              generator=gen)
                for name, arr in (("generated_enc", out["encoder_outputs"][0].T),
                                  ("generated_dec", out["decoder_outputs"][0].T),
                                  ("alignment", out["attn"][0])):
                    if tb is not None:
                        tb.add_image(f"{name}/{i}", plot_tensor(arr), epoch,
                                     dataformats="HWC")
        except Exception as e:  # rendering must never kill training
            print(f"validation image rendering failed: {e!r}")

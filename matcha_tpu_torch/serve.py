"""Batched text -> waveform serving engine on fixed-shape CUDA graphs.

The port of `matcha_tpu/serve.py` on one device. Every request runs as a few
fixed-shape stages, and on the card each stage is a CUDA graph, captured once
and then replayed, so the host issues one graph launch where eager PyTorch
issues thousands of kernels:

  * encode, per (batch, text bucket): the text encoder and durations; the
    host then reads the predicted lengths and picks the smallest mel budget
    that fits;
  * decode, per (batch, text bucket, budget): alignment path, ODE decode over
    the U-Net, the vocoder (HiFi-GAN clipped to [-1, 1], or Griffin-Lim on
    exp(mel)) and packing into rows of [waveform..., clamped mel length,
    unclamped predicted length] in the wire dtype;
  * low-latency, per (text bucket, budget): encode, decode, vocode and pack in
    one graph at a fixed budget, with no host read before the single
    device-to-host copy (`synthesise_lowlatency`).

A stage's graph is captured at its first use (or by `warmup`), under the
engine lock, after one eager run on a side stream that builds the kernels,
K2's packed weights, the cuFFT plans and cuBLAS and cuDNN state. All graphs
share one memory pool, so a graph's outputs are copied out (into the next
graph's static inputs, or to the host) before any other replay, on one stream,
under the lock. On CPU tensors the same stages run eagerly: CUDA graphs exist
only on the card, and on the card a stage replays its graph or raises; there
is no eager path there. The decoder attention and the MRF steps are the CUDA
kernels K1 and K2 inside the graphs; a graph records the launches its capture
made and each replay adds them to `TTSEngine.launches`. A graph reads the
weights by address, so the engine never reloads or casts its modules after
construction (K2's packing would go stale inside the graphs).

Noise `z` and the Griffin-Lim phase are drawn outside the graphs from explicit
`torch.Generator`s and copied into the static inputs. With `seeds=`, request
i's generator is `manual_seed(seeds[i])`: its noise (budget, n_feats) first,
then its phase (n_freq, budget), so a waveform depends only on (text, seed,
budget), never on its batch mates. torch has no threefry, so these are not the
JAX package's numbers; parity runs inject `z` and the phase.

`serve(text, seed)` is the concurrent entry point: a worker started by
`start_batching` groups co-arriving requests (up to `max_batch`, waiting at
most `max_wait_ms`) and runs a two-stage pipeline. Stage A encodes the group,
reads the predicted lengths, and per budget sub-group (padded to a power of
two by repeating row 0) replays the decode graph and starts a non-blocking
copy into a pinned host buffer owned by that group, followed by a CUDA event.
Stage B, a delivery thread, waits on the event outside the engine lock,
slices and delivers. With one configured budget, stage A reads nothing back
(zero-sync) and truncation is read from the packed tail in stage B.

`mesh=` (`parallel.make_mesh(devices=...)`, one process over its local
cards): the weights are copied to each card, and each card has its own
stages, graphs and pool. A request batch is padded to a multiple of the card
count by repeating row 0 and split batch-wise; each card replays its stage on
its block of rows, on its own stream, and the outputs are gathered. The
noise and phase are drawn for the batch, as without a mesh, then split, so
the waveforms do not depend on the card count. The batching worker and
`synthesise_lowlatency` (whose one row runs on the first card, the padding
rows on the others) take the mesh alike.

The JAX engine's TPU-measured selection knobs (`attn_impl`,
`attn_pallas_min_budget`, `vocoder_resblock_impl`) are not ported: on the card
the port always runs its kernels.
"""

import copy
import functools
import queue
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from matcha_tpu_torch import apply_tf32_policy, resolve_device
from matcha_tpu_torch.audio.griffin_lim import draw_phase, mel_to_audio
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.models.precision import bf16_serving
from matcha_tpu_torch.ops.attention import attention
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.ops.mrf import mrf_step
from matcha_tpu_torch.text import simple_text_to_sequence
from matcha_tpu_torch.utils.profiling import rtf

# the kernel wrappers whose launches a graph records at capture
COUNTED = {"attention_fwd": attention, "mrf_step": mrf_step}


def pow2(n: int) -> int:
    """The smallest power of two >= n: the batch of a padded request group."""
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class ServeConfig:
    n_timesteps: int = 10
    temperature: float = 1.0
    length_scale: float = 1.0
    text_pad_multiple: int = 16
    max_text_len: int = 256
    # mel-frame budgets; a batch decodes at the smallest one that fits its
    # longest predicted utterance (each a multiple of 4, the U-Net's factor)
    mel_budgets: Tuple[int, ...] = (128, 256, 512, 1024)
    max_batch: int = 16
    bf16: bool = False
    vocoder: str = "griffin_lim"  # or "hifigan"
    # "float32", or "int16": 16-bit PCM quantized on the device, as a PCM16
    # wav stores it (4x less device->host traffic)
    output_dtype: str = "float32"
    mel_cfg: MelConfig = field(default_factory=MelConfig)
    # batching front end: how long the worker waits for co-arriving requests
    # before it dispatches a partial batch
    max_wait_ms: float = 5.0

    def text_bucket(self, longest: int) -> int:
        """Padded token length of a batch whose longest text has `longest` ids."""
        tx = -(-longest // self.text_pad_multiple) * self.text_pad_multiple
        return max(min(tx, self.max_text_len), 1)


class _Request:
    """One queued `serve()` call: text and seed in, waveform (or error) out."""

    __slots__ = ("text", "seed", "event", "wav", "info", "error", "t_enqueue", "dispatched")

    def __init__(self, text: str, seed: int):
        self.text = text
        self.seed = seed
        self.event = threading.Event()
        self.wav = None
        self.info = None
        self.error = None
        self.t_enqueue = time.perf_counter()
        self.dispatched = False  # True once its sub-group's decode is in flight


class _Eager:
    """A stage on the CPU, run eagerly: CUDA graphs exist only on the card."""

    launches = {}

    def __init__(self, fn):
        self.run = fn


class _Graph:
    """A stage captured as one CUDA graph at fixed shapes.

    The inputs are static buffers allocated outside the graph's pool; `run`
    copies the caller's tensors into them and replays. The outputs live in the
    engine's shared pool, where a graph captured later may keep intermediates,
    so the caller copies them out before any other replay. `launches` holds
    the launches of the `counted` wrappers that the capture recorded, which
    each replay repeats; `replays` counts the replays. `generators` are
    registered with the graph, so that each replay draws fresh numbers from
    them.
    """

    def __init__(self, fn, args, device, pool, generators=(), counted=COUNTED):
        self.inputs = tuple(torch.empty(a.shape, dtype=a.dtype, device=device)
                            .copy_(a, non_blocking=True) for a in args)
        # one eager run builds what is built at first use: the kernels, K2's
        # packed weights, cuFFT plans, cuBLAS and cuDNN state
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        before = {name: w.launches for name, w in counted.items()}
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        # thread_local: the delivery thread's event waits and host reads may
        # run while this thread captures
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)
        self.launches = {name: w.launches - before[name] for name, w in counted.items()}
        self.replays = 0

    def run(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.outputs


class _Events(list):
    """CUDA events, one a device, waited for together."""

    def synchronize(self):
        for e in self:
            e.synchronize()


class _Replica:
    """The engine's modules on one device, with that device's stages (a
    `_Graph` a stage key on a card, `_Eager` on the CPU) and graph pool."""

    def __init__(self, cfg: "ServeConfig", model, vocoder, device: torch.device):
        self.cfg, self.model, self.vocoder, self.device = cfg, model, vocoder, device
        self.stages = {}
        self.pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None

    def encode(self, x, xl):
        return self.model.encode_durations(x, xl, self.cfg.length_scale)

    def _vocode(self, mel, phase):
        if self.vocoder is not None:
            return torch.clamp(self.vocoder(mel).float(), -1.0, 1.0)
        return mel_to_audio(self.cfg.mel_cfg, mel.transpose(1, 2), phase=phase)

    def decode(self, budget: int, mu_x, w_ceil, x_mask, y_lengths, z, phase=None):
        """Decode + vocode + pack: (B, budget*hop + 2) rows laid out as
        [waveform..., mel length, predicted length] in the wire dtype."""
        out = self.model.decode_fixed(mu_x, w_ceil, x_mask, y_lengths, budget,
                                      self.cfg.n_timesteps, self.cfg.temperature, z=z)
        wav = self._vocode(out["mel"], phase)
        if self.cfg.output_dtype == "int16":
            wav = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        tails = torch.stack([out["mel_lengths"], torch.clamp(y_lengths, max=32767)], dim=1)
        return torch.cat([wav, tails.to(wav.dtype)], dim=1)

    def synth(self, budget: int, x, xl, z, phase=None):
        """The low-latency stage: encode and decode at a fixed budget."""
        return self.decode(budget, *self.encode(x, xl), z, phase)

    def run(self, key, fn, *args):
        """Stage `key` on `args`: on a card its graph replays, captured first
        if it is new; its outputs must be copied out before the next `run`.
        Returns (outputs, the kernel launches it made)."""
        stage = self.stages.get(key)
        if stage is None:
            stage = self.stages[key] = (_Eager(fn) if self.device.type == "cpu"
                                        else _Graph(fn, args, self.device, self.pool))
        return stage.run(*args), stage.launches


class TTSEngine:
    """Batched text -> waveform synthesis on one device, or batch-parallel over
    the devices of `mesh`."""

    def __init__(self, params, model_cfg: MatchaConfig = MatchaConfig(),
                 cfg: ServeConfig = ServeConfig(), vocoder_params=None,
                 hifigan_cfg: Optional[HiFiGANConfig] = None, device=None, seed: int = 0,
                 mesh=None):
        """`params`: a MatchaTTS state dict; `vocoder_params`: a HiFi-GAN
        generator state dict, plain or weight-normed (hifigan only).
        `device=None` is the card; `mesh`, a device mesh
        (`parallel.make_mesh(devices=...)`), serves over its devices instead."""
        if cfg.vocoder not in ("griffin_lim", "hifigan"):
            raise ValueError(f"unknown vocoder {cfg.vocoder!r}")
        if cfg.vocoder == "hifigan" and vocoder_params is None:
            raise ValueError("the hifigan vocoder needs vocoder_params (a generator state dict)")
        if cfg.vocoder == "griffin_lim" and cfg.mel_cfg.n_mels != model_cfg.n_feats:
            raise ValueError(f"Griffin-Lim inverts {cfg.mel_cfg.n_mels} mels, the model "
                             f"makes {model_cfg.n_feats}")
        if cfg.output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be 'float32' or 'int16', got {cfg.output_dtype!r}")
        self.cfg = cfg
        devices = [resolve_device(device)] if mesh is None else list(mesh.devices)
        for d in devices:
            resolve_device(d)
        self.device = devices[0]
        if any(d.type == "cuda" for d in devices):
            apply_tf32_policy()
        model = MatchaTTS(model_cfg)
        model.load_state_dict(params)
        vocoder = None
        if cfg.vocoder == "hifigan":
            vocoder = Generator(hifigan_cfg or HiFiGANConfig())
            vocoder.load_state_dict(vocoder_params)
        self._replicas = []
        for i, dev in enumerate(devices):  # the first device takes the modules, the others copies
            mods = [model, vocoder] if i == 0 else [copy.deepcopy(model), copy.deepcopy(vocoder)]
            for m in mods:
                if m is not None:
                    m.eval().to(dev)
                    if cfg.bf16:
                        bf16_serving(m)
            self._replicas.append(_Replica(cfg, *mods, dev))
        first = self._replicas[0]
        self.model, self.vocoder = first.model, first.vocoder
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        # the first device's stage key -> _Graph on the card, _Eager on the CPU
        self._stages, self._pool = first.stages, first.pool
        # kernel launches made by this engine's graph replays, by kernel
        self.launches = {name: 0 for name in COUNTED}
        # serializes the engine rng, captures and each request group's device sequence
        self._lock = threading.Lock()
        # batching front end, started on demand by start_batching
        self._pending: list = []
        self._pending_cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._stop_worker = False

    # ----------------------------------------------------------- stages
    def _encode(self, x, xl):
        return self._replicas[0].encode(x, xl)

    def _decode(self, budget: int, *args):
        return self._replicas[0].decode(budget, *args)

    def _synth(self, budget: int, *args):
        return self._replicas[0].synth(budget, *args)

    def _split(self, tensors):
        """[the block of rows of `tensors` on each device], in device order."""
        out = []
        for i, rep in enumerate(self._replicas):
            b = tensors[0].shape[0] // len(self._replicas)
            out.append([t[i * b: (i + 1) * b].to(rep.device, non_blocking=True)
                        for t in tensors])
        return out

    def _sharded(self, key, stage: str, args, whole=()):
        """`_Replica.<stage>(*whole, *args[i])` on device i, through the stage
        of key(args[i]); caller holds the lock. Returns the devices' outputs,
        which must be copied out before that device's next stage."""
        outs = []
        for rep, a in zip(self._replicas, args):
            out, launches = rep.run(key(a), functools.partial(getattr(rep, stage), *whole), *a)
            for name, c in launches.items():
                self.launches[name] += c
            outs.append(out)
        return outs

    def _encode_run(self, x, xl):
        """The encode stage on each device's rows: a tuple of outputs a device."""
        return self._sharded(lambda a: ("encode",) + tuple(a[0].shape), "encode",
                             self._split((x, xl)))

    def _decode_run(self, encs, draws, budget: int):
        """The decode stage on each device's encode outputs and its block of
        the draws: a packed block a device."""
        args = [list(enc) + d for enc, d in zip(encs, self._split(draws))]
        return self._sharded(lambda a: ("decode",) + tuple(a[0].shape[:2]) + (budget,), "decode",
                             args, whole=(budget,))

    def _lowlatency_run(self, x, xl, draws, budget: int):
        return self._sharded(lambda a: ("lowlatency", a[0].shape[1], budget), "synth",
                             self._split((x, xl) + tuple(draws)), whole=(budget,))

    # ------------------------------------------------------------ host side
    def _rows(self, n: int) -> int:
        """n rounded up to a multiple of the device count."""
        return n + -n % len(self._replicas)

    def _tokenize(self, texts: Sequence[str], pad_pow2: bool = False):
        """Token ids (n, text bucket) and lengths (n,) on the host (pinned for
        a card); `pad_pow2` rounds n up to a power of two, and a mesh to a
        multiple of its device count, by repeating row 0."""
        cfg = self.cfg
        seqs = [simple_text_to_sequence(t)[: cfg.max_text_len] for t in texts]
        n = self._rows(pow2(len(seqs)) if pad_pow2 else len(seqs))
        seqs += [seqs[0]] * (n - len(seqs))
        x = np.zeros((n, cfg.text_bucket(max(len(s) for s in seqs))), np.int64)
        xl = np.array([len(s) for s in seqs], np.int64)
        for i, s in enumerate(seqs):
            x[i, : len(s)] = s
        x, xl = torch.from_numpy(x), torch.from_numpy(xl)
        if self.device.type == "cuda":
            x, xl = x.pin_memory(), xl.pin_memory()
        return x, xl

    def _pick_budget(self, max_frames: int) -> int:
        for b in sorted(self.cfg.mel_budgets):
            if b >= max_frames:
                return b
        return max(self.cfg.mel_budgets)

    def _draws(self, n: int, budget: int, seed: Optional[int],
               seeds: Optional[Sequence[int]]):
        """(z,) or, for Griffin-Lim, (z, phase): f32 pre-temperature noise
        (n, budget, n_feats) and initial phase (n, n_freq, budget), then rows
        repeating row 0 up to a multiple of the device count."""
        draws = self._draw(n, budget, seed, seeds)
        pad = self._rows(n) - n
        if pad == 0:
            return draws
        return tuple(torch.cat([d, d[:1].expand(pad, *d.shape[1:])]) for d in draws)

    def _draw(self, n: int, budget: int, seed: Optional[int],
              seeds: Optional[Sequence[int]]):
        """The n rows of `_draws`, on the first device."""
        nf = self.model.cfg.n_feats
        n_freq = self.cfg.mel_cfg.n_fft // 2 + 1

        def draw(lead, gen):
            z = torch.randn(lead + (budget, nf), generator=gen, device=self.device)
            if self.vocoder is not None:
                return (z,)
            return z, draw_phase(lead + (n_freq, budget), gen, self.device)

        if seeds is not None:
            per = [draw((), torch.Generator(device=self.device).manual_seed(int(s)))
                   for s in seeds]
            return tuple(torch.stack(parts) for parts in zip(*per))
        gen = (torch.Generator(device=self.device).manual_seed(int(seed))
               if seed is not None else self._rng)
        return draw((n,), gen)

    def _host_lengths(self, encs, n: int):
        """The first n predicted lengths of the devices' encode outputs, read
        to the host (a sync on the card)."""
        return [int(v) for v in torch.cat([e[3].cpu() for e in encs])[:n].tolist()]

    def _to_host(self, packed):
        """Start the copies of the devices' `packed` blocks into one host
        buffer (pinned on the card): (buffer, None on the CPU, else an object
        whose `synchronize()` waits for the copies)."""
        if self.device.type == "cpu":
            return (packed[0] if len(packed) == 1 else torch.cat(packed)), None
        rows = sum(p.shape[0] for p in packed)
        host = torch.empty((rows,) + tuple(packed[0].shape[1:]), dtype=packed[0].dtype,
                           pin_memory=True)
        events, start = [], 0
        for p in packed:
            host[start: start + p.shape[0]].copy_(p, non_blocking=True)
            start += p.shape[0]
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(p.device))
        return host, (events[0] if len(events) == 1 else _Events(events))

    def _finish(self, packed: np.ndarray, n: int):
        hop = self.cfg.mel_cfg.hop_size
        wav, lengths = packed[:n, :-2], packed[:n, -2].astype(np.int32)
        predicted = packed[:n, -1].astype(np.int32)
        wavs = [wav[i, : min(int(lengths[i]) * hop, wav.shape[1])] for i in range(n)]
        return wavs, lengths, predicted

    def _info(self, wall, budget, lengths, truncated):
        hop, sr = self.cfg.mel_cfg.hop_size, self.cfg.mel_cfg.sample_rate
        return {"rtf": rtf(wall, int(lengths.sum()), hop, sr), "budget": budget,
                "wall_s": wall, "mel_lengths": lengths.tolist(), "truncated": truncated}

    # ------------------------------------------------------------- API
    def warmup(self, batch_sizes: Sequence[int] = (1,), text: str = "warm up the kernels"):
        """Capture the graphs a request of `text`'s bucket can replay: encode
        and decode at every budget for each batch size, and at batch 1 the
        low-latency graph at every budget. Warm each text bucket you serve."""
        for bs in batch_sizes:
            with self._lock:
                x, xl = self._tokenize([text] * bs)
                enc = [tuple(t.clone() for t in e) for e in self._encode_run(x, xl)]
                for budget in self.cfg.mel_budgets:
                    draws = self._draws(bs, budget, 0, None)
                    self._decode_run(enc, draws, budget)
                    if bs == 1:
                        self._lowlatency_run(x, xl, draws, budget)
        for rep in self._replicas:
            if rep.device.type == "cuda":
                torch.cuda.synchronize(rep.device)

    def synthesise(self, texts: Sequence[str], seed: Optional[int] = None,
                   seeds: Optional[Sequence[int]] = None):
        """Texts -> (list of waveforms, info). Thread-safe.

        `seed`: one noise (and phase) draw shaped over the batch. `seeds`: one
        seed per text, each waveform a function of (text, seed, budget) only.
        Neither: the engine's own generator. Waveforms are float32, or int16
        when `output_dtype="int16"`.
        """
        cfg = self.cfg
        if len(texts) == 0:
            return [], {"rtf": float("nan"), "budget": 0}
        if len(texts) > cfg.max_batch:
            raise ValueError(f"batch of {len(texts)} exceeds max_batch={cfg.max_batch}")
        if seeds is not None and len(seeds) != len(texts):
            raise ValueError("seeds must have one entry per text")
        with self._lock:
            t0 = time.perf_counter()
            x, xl = self._tokenize(texts)
            enc = self._encode_run(x, xl)
            y_pred = self._host_lengths(enc, len(texts))  # the one host read: picks the budget
            budget = self._pick_budget(fix_len_compatibility(max(y_pred)))
            draws = self._draws(len(texts), budget, seed, seeds)
            packed = np.concatenate([p.cpu().numpy() for p in
                                     self._decode_run(enc, draws, budget)])
            wall = time.perf_counter() - t0
        wavs, lengths, _ = self._finish(packed, len(texts))
        truncated = [p > budget for p in y_pred]
        if any(truncated):
            warnings.warn(
                f"{sum(truncated)}/{len(texts)} utterance(s) exceed the largest mel budget "
                f"({budget} frames) and were truncated; raise ServeConfig.mel_budgets "
                "for longer audio", stacklevel=2)
        return wavs, self._info(wall, budget, lengths, truncated)

    def synthesise_lowlatency(self, text: str, seed: Optional[int] = None,
                              budget: Optional[int] = None):
        """One utterance at a fixed `budget` (default: the largest), in one graph
        with no host read before its device-to-host copy. Returns (waveform,
        info); with a seed, equals `synthesise([text], seeds=[seed])` when that
        picks the same budget."""
        budget = budget if budget is not None else max(self.cfg.mel_budgets)
        with self._lock:
            t0 = time.perf_counter()
            x, xl = self._tokenize([text])
            draws = self._draws(1, budget, None, None if seed is None else [seed])
            packed = np.concatenate([p.cpu().numpy() for p in
                                     self._lowlatency_run(x, xl, draws, budget)])
            wall = time.perf_counter() - t0
        wavs, lengths, predicted = self._finish(packed, 1)
        truncated = int(predicted[0]) > budget
        if truncated:
            warnings.warn(f"utterance predicts {int(predicted[0])} mel frames, beyond the "
                          f"{budget}-frame budget; output truncated, pass a larger `budget`",
                          stacklevel=2)
        return wavs[0], self._info(wall, budget, lengths, truncated)

    # --------------------------------------------------- batching front end
    def start_batching(self, max_wait_ms: Optional[float] = None):
        """Start the background worker that batches concurrent `serve()` calls."""
        wait_s = (max_wait_ms if max_wait_ms is not None else self.cfg.max_wait_ms) / 1e3
        with self._pending_cv:
            if self._worker is not None and self._worker.is_alive():
                return
            self._stop_worker = False
            self._worker = threading.Thread(target=self._batch_worker, args=(wait_s,),
                                            daemon=True, name="tts-batch-worker")
            self._worker.start()

    def stop_batching(self):
        """Stop the worker once it has drained the queue."""
        with self._pending_cv:
            self._stop_worker = True
            self._pending_cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
            if self._worker.is_alive():
                # keep the reference, so that start_batching() cannot start a
                # second worker draining the same queue
                raise RuntimeError("batching worker still processing after 30 s join "
                                   "timeout; not restartable until it drains")
            self._worker = None

    def serve(self, text: str, seed: int):
        """Thread-safe single-utterance entry: enqueue, batch with concurrent
        requests, block until this request's waveform is ready. Returns
        (waveform, info); the waveform depends only on (text, seed, budget)."""
        req = _Request(text, int(seed))
        with self._pending_cv:
            # liveness is checked inside the condition lock: a concurrent
            # stop_batching() cannot slip between the check and the enqueue
            if self._worker is None or not self._worker.is_alive() or self._stop_worker:
                raise RuntimeError("batching worker not running; call start_batching()")
            self._pending.append(req)
            self._pending_cv.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.wav, req.info

    def _batch_worker(self, wait_s: float):
        """Stage A: collect a group (at most `max_batch`, waiting at most
        `wait_s` for co-arriving requests) and dispatch it; stage B, a delivery
        thread, waits on each sub-group's copy. At most 2 sub-groups wait for
        delivery (backpressure on pinned and device memory)."""
        deliveries: "queue.Queue" = queue.Queue(maxsize=2)
        deliverer = threading.Thread(target=self._delivery_worker, args=(deliveries,),
                                     daemon=True, name="tts-delivery-worker")
        deliverer.start()
        try:
            while True:
                with self._pending_cv:
                    while not self._pending and not self._stop_worker:
                        self._pending_cv.wait()
                    if self._stop_worker and not self._pending:
                        return
                    deadline = time.monotonic() + wait_s
                    while len(self._pending) < self.cfg.max_batch and not self._stop_worker:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._pending_cv.wait(remaining)
                    reqs = self._pending[: self.cfg.max_batch]
                    del self._pending[: len(reqs)]
                try:
                    self._dispatch_group(reqs, deliveries)
                except Exception as e:  # the worker keeps serving; fail only the
                    for r in reqs:      # requests whose sub-group was not dispatched
                        if not r.event.is_set() and not r.dispatched:
                            r.error = e
                            r.event.set()
        finally:
            deliveries.put(None)  # sentinel: drain, then exit
            deliverer.join()

    def _dispatch_group(self, reqs, out_q):
        """Stage A for one group: encode it together, pick each request's own
        budget, and per budget sub-group replay the decode graph with each
        request's own seed and hand the in-flight copy to stage B.

        A sub-group is padded to a power of two by repeating its first row, and
        one whose rows differ from the group's re-runs the encode graph at its
        own batch (as the JAX engine does), which keeps every replay at a warmed
        (batch, text bucket) shape. With one configured budget nothing is read
        back here: stage B reads truncation from the packed tail.
        """
        t0 = time.perf_counter()
        with self._lock:
            x, xl = self._tokenize([r.text for r in reqs], pad_pow2=True)
            enc = self._encode_run(x, xl)
            if len(self.cfg.mel_budgets) == 1:
                y_pred = None  # zero-sync: the budget is known
                by_budget = {self.cfg.mel_budgets[0]: list(range(len(reqs)))}
            else:
                y_pred = self._host_lengths(enc, len(reqs))  # the one stage-A host read
                by_budget = {}
                for i, f in enumerate(y_pred):
                    by_budget.setdefault(self._pick_budget(fix_len_compatibility(f)), []).append(i)
            wall_encode = time.perf_counter() - t0
            for budget, idx in sorted(by_budget.items()):
                t_sub = time.perf_counter()
                sel = idx + [idx[0]] * (self._rows(pow2(len(idx))) - len(idx))
                if len(idx) != len(reqs):  # other rows: encode them at their own batch
                    enc = self._encode_run(*self._tokenize([reqs[i].text for i in sel]))
                draws = self._draws(len(sel), budget, None, [reqs[i].seed for i in sel])
                host, done = self._to_host(self._decode_run(enc, draws, budget))
                for i in idx:
                    reqs[i].dispatched = True
                # blocks only while 2 sub-groups wait for delivery
                out_q.put((host, done, reqs, idx, budget, y_pred, wall_encode, t_sub))

    def _delivery_worker(self, out_q):
        """Stage B: wait on each sub-group's copy, slice, deliver; outside the
        engine lock, so stage A keeps dispatching.

        `wall_s` is the request's own compute path (the group's encode and its
        sub-group's dispatch and copy, waits included); `latency_s` is enqueue
        to delivery (batching window and queueing included)."""
        hop, sr = self.cfg.mel_cfg.hop_size, self.cfg.mel_cfg.sample_rate
        while True:
            item = out_q.get()
            if item is None:
                return
            host, done, reqs, idx, budget, y_pred, wall_encode, t_sub = item
            try:
                if done is not None:
                    done.synchronize()
                wavs, lengths, predicted = self._finish(host.numpy(), len(idx))
                now = time.perf_counter()
                wall = wall_encode + (now - t_sub)
                for j, i in enumerate(idx):
                    ml = int(lengths[j])
                    # y_pred is None on the zero-sync path: read the packed tail
                    pred = int(predicted[j]) if y_pred is None else y_pred[i]
                    trunc = pred > budget
                    if trunc:
                        warnings.warn(f"request predicts {pred} mel frames, beyond the "
                                      f"largest budget ({budget}); output truncated",
                                      stacklevel=2)
                    reqs[i].wav = wavs[j]
                    reqs[i].info = {
                        "budget": budget, "mel_length": ml, "wall_s": wall,
                        "latency_s": now - reqs[i].t_enqueue,
                        "rtf": rtf(wall, ml, hop, sr), "group_size": len(reqs),
                        "truncated": trunc,
                    }
                    reqs[i].event.set()
            except Exception as e:  # fail only this sub-group's requests
                for i in idx:
                    if not reqs[i].event.is_set():
                        reqs[i].error = e
                        reqs[i].event.set()

"""The port's training dispatch and the trainer's options against the JAX
package's behaviours (CPU, reduced widths, dropout on).

- the optimizer follows optax MultiSteps(2) when its scalar rows come in
  chunks [1, 3, 1], so that a K-chunk starts mid-accumulation (atol 1e-6, the
  bar of `test_optimizer_trajectory_matches_optax`);
- K micro-steps in one dispatch equal K single steps, `fit` logs every step
  at K = 2 and resumes, and an epoch over several buckets trains the same
  trajectory at K = 1 and K = 3: the JAX tests `test_scan_dispatch_equals_
  sequential_steps`, `test_trainer_fit_steps_per_dispatch` and
  `test_k_dispatch_trajectory_bucket_independent`, with their bars; a K-step
  dispatch logs only the steps `log_every` picks;
- `DecoderConfig.remat` ("full", "dots") gives the gradients of no remat,
  with unchanged state-dict keys, and reruns the attention forward once per
  block in the backward;
- `profile_dir` writes a trace, closed when the run ends early;
- validation rendering is gated on TensorBoard and follows the checkpoint
  cadence (the JAX test `test_render_gating_no_collective_without_tb`);
- `mas_impl` names; `StepTimer` and `rtf` as `matcha_tpu.utils.profiling`'s.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.train import trainer as jax_trainer
from matcha_tpu.utils import profiling as jax_profiling
from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, collate
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.ops import attention as attention_ops
from matcha_tpu_torch.train import trainer as trainer_module
from matcha_tpu_torch.train.trainer import (
    METRICS,
    TrainConfig,
    Trainer,
    make_optimizer,
)
from matcha_tpu_torch.utils import profiling

TINY = tiny_config()
DATA = DataConfig(batch_size=4, text_pad_multiple=16, mel_pad_multiple=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Loggers without TensorBoard (the render tests set their own board): its
    import and the validation images would cost each fit seconds here."""
    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)


def _rows(path):
    rows = [json.loads(line) for line in (path / "logs" / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "train/loss" in r]


# ---------------------------------------------------------------- optimizer
def test_optimizer_rows_in_chunks_match_optax():
    """Five micro-steps of MultiSteps(2) whose rows come as chunks [1, 3, 1]:
    the 3-chunk starts after an odd micro-step, mid-accumulation."""
    cfg = dict(lr=3e-2, eta_min=1e-3, cosine_epochs=3, weight_decay=1e-2, accumulate_steps=2)
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.1, 2.0, 0.05, 3.0, 0.3)]

    tx = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**cfg), steps_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = make_optimizer(TrainConfig(**cfg), 1, list(params.values()))
    i = 0
    for k in (1, 3, 1):
        rows, emits = opt.advance(k)
        assert (opt.mini_step, opt.count) == ((i + k) % 2, (i + k) // 2)  # host counters move
        assert emits == tuple((j + 1) % 2 == 0 for j in range(i, i + k))
        for row, emit in zip(torch.from_numpy(rows), emits):
            g = grads[i]
            updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()}, state, jparams)
            jparams = optax.apply_updates(jparams, updates)
            opt.apply([torch.from_numpy(g[n]) for n in params], row, emit)
            for n in params:
                np.testing.assert_allclose(params[n].numpy(), np.asarray(jparams[n]), atol=1e-6,
                                           rtol=0, err_msg=f"micro-step {i} {n}")
            i += 1
    assert opt.count == 2 and opt.mini_step == 1
    # the checkpoint format keeps its ints
    assert isinstance(opt.state_dict()["count"], int)


# ---------------------------------------------------------------- dispatch
def _batches(n=3):
    ds = SyntheticDataset(n_items=4 * n, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    return [collate([ds.get(i) for i in range(j * 4, (j + 1) * 4)], DATA, shape=(16, 32))
            for j in range(n)]


def _trainer(tmp_path, name, **kw):
    cfg = TrainConfig(ckpt_dir=str(tmp_path / name), **kw)
    trainer = Trainer(TINY, cfg, DATA, device="cpu")
    trainer.init_optimizer(100)
    return trainer


def _param_gaps(a, b):
    return np.concatenate([(x.detach() - y.detach()).abs().flatten().numpy()
                           for x, y in zip(a.params, b.params)])


def test_k_step_dispatch_equals_sequential_steps(tmp_path):
    """Three micro-steps as one dispatch and as three `train_step`s, through
    an accumulation boundary, dropout on: equal per-step metrics (the JAX
    test's bars), parameters within one sign-flipped AdamW step."""
    batches = _batches()
    seq = _trainer(tmp_path, "seq", accumulate_steps=2)
    seq_metrics = [seq.train_step(b, 0, j) for j, b in enumerate(batches)]
    k = _trainer(tmp_path, "k", accumulate_steps=2)
    out = k.dispatch([(b, j) for j, b in enumerate(batches)], 0)
    assert out.shape == (3, len(METRICS))
    for j in range(3):
        for i, name in enumerate(METRICS):
            np.testing.assert_allclose(float(out[j, i]), float(seq_metrics[j][name]),
                                       rtol=2e-5, atol=1e-6, err_msg=f"step {j} {name}")
    gaps = _param_gaps(seq, k)
    assert gaps.max() < 3 * seq.train_cfg.lr and (gaps > 1e-6).mean() < 0.02
    assert (k.optimizer.mini_step, k.optimizer.count) == (seq.optimizer.mini_step,
                                                           seq.optimizer.count) == (1, 1)
    # dropout is on: a different dropout seed gives a different step
    other = _trainer(tmp_path, "other", accumulate_steps=2)
    assert float(other.train_step(batches[0], 0, 5)["loss"]) != float(seq_metrics[0]["loss"])


def test_trainer_fit_steps_per_dispatch(tmp_path):
    """fit at K = 2: the step count, a metric row per step, and a resume."""
    cfg = dict(ckpt_dir=str(tmp_path / "ckpts"), accumulate_steps=1, log_every=1,
               log_grad_norm=False, steps_per_dispatch=2)
    train = SyntheticDataset(n_items=16, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    val = SyntheticDataset(n_items=4, n_mels=TINY.n_feats, seed=1, min_frames=16, max_frames=32)
    trainer = Trainer(TINY, TrainConfig(**cfg), DATA, device="cpu")
    assert trainer.fit(train, val, max_epochs=1, resume=False) == 4
    rows = _rows(tmp_path / "ckpts")
    assert sorted(r["step"] for r in rows) == [0, 1, 2, 3]
    assert not any("train/grad_norm" in r for r in rows)
    again = Trainer(TINY, TrainConfig(**cfg), DATA, device="cpu")
    assert again.fit(train, val, max_epochs=2, resume=True) == 8
    assert again.optimizer.count == 8


def test_fit_logs_only_log_every_steps_of_k_dispatches(tmp_path):
    """K = 2 and log_every = 3: a dispatch's rows are logged only at the steps
    the cadence picks, whichever dispatch holds them."""
    cfg = TrainConfig(ckpt_dir=str(tmp_path / "ck"), accumulate_steps=1, log_every=3,
                      steps_per_dispatch=2)
    train = SyntheticDataset(n_items=28, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    val = SyntheticDataset(n_items=4, n_mels=TINY.n_feats, seed=1, min_frames=16, max_frames=32)
    trainer = Trainer(TINY, cfg, DATA, device="cpu")
    assert trainer.fit(train, val, max_epochs=1, resume=False) == 7
    rows = _rows(tmp_path / "ck")
    assert [r["step"] for r in rows] == [0, 3, 6]
    assert all(np.isfinite(r["train/grad_norm"]) and r["epoch"] == 0 for r in rows)


def test_k_dispatch_trajectory_bucket_independent(tmp_path, monkeypatch):
    """An epoch over several buckets trains the same trajectory at K = 1 and
    K = 3 (dropout on): per-step losses within the JAX test's bars, final
    parameters within its drift bounds; K = 3 ran groups of 3."""
    train = SyntheticDataset(n_items=24, n_mels=TINY.n_feats, min_frames=16, max_frames=90)
    val = SyntheticDataset(n_items=4, n_mels=TINY.n_feats, seed=1, min_frames=16, max_frames=32)
    data = DataConfig(batch_size=4, text_pad_multiple=16, mel_pad_multiple=32)
    sizes = []
    dispatch = Trainer.dispatch

    def recording(self, chunk, epoch, eager=False):
        sizes.append(len(chunk))
        return dispatch(self, chunk, epoch, eager)

    monkeypatch.setattr(Trainer, "dispatch", recording)
    trainers, logs = [], []
    for k in (1, 3):
        cfg = TrainConfig(ckpt_dir=str(tmp_path / f"k{k}"), accumulate_steps=1, log_every=1,
                          log_grad_norm=False, steps_per_dispatch=k)
        trainer = Trainer(TINY, cfg, data, device="cpu")
        trainer.fit(train, val, max_epochs=1, resume=False)
        trainers.append(trainer)
        logs.append({r["step"]: r["train/loss"] for r in _rows(tmp_path / f"k{k}")})
    assert len({32 * ((train.mel_length(i) + 31) // 32) for i in range(24)}) > 1
    assert 3 in sizes and 1 in sizes
    assert set(logs[0]) == set(logs[1]) and len(logs[0]) >= 4
    for s in logs[0]:
        np.testing.assert_allclose(logs[0][s], logs[1][s], rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {s}")
    gaps = _param_gaps(*trainers)
    assert gaps.max() < 3e-4 and (gaps > 1e-6).mean() < 0.02


# ---------------------------------------------------------------- remat
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_remat_gradients_equal_no_remat(remat, dtype, monkeypatch):
    """Dropout on, the same generators: the gradients of no remat; the same
    state-dict keys; the attention forward runs twice per block."""
    calls = []
    forward = attention_ops.attention_forward
    monkeypatch.setattr(attention_ops, "attention_forward",
                        lambda *a, **kw: calls.append(1) or forward(*a, **kw))
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}

    def grads(cfg):
        torch.manual_seed(0)
        model = MatchaTTS(cfg).train()
        calls.clear()
        from matcha_tpu_torch.nn.dropout import dropout_generator

        with dropout_generator(torch.Generator().manual_seed(5)):
            out = model.compute_losses(batch["x"], batch["x_lengths"], batch["y"],
                                       batch["y_lengths"], decoder_dtype=dtype,
                                       generator=torch.Generator().manual_seed(3))
            loss = out["dur_loss"] + out["prior_loss"] + out["diff_loss"]
            g = torch.autograd.grad(loss, list(model.parameters()))
        return model, loss.detach(), g, len(calls)

    base_model, base_loss, base, base_calls = grads(TINY)
    cfg = dataclasses.replace(TINY, decoder=dataclasses.replace(TINY.decoder, remat=remat))
    model, loss, got, n_calls = grads(cfg)
    assert list(model.state_dict()) == list(base_model.state_dict())
    assert torch.equal(loss, base_loss)
    for a, b in zip(got, base):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    n_blocks = 2 * len(TINY.decoder.channels) + TINY.decoder.num_mid_blocks
    assert base_calls == n_blocks and n_calls == 2 * n_blocks
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(TINY.decoder, remat="some")


# ---------------------------------------------------------------- options
def _fit_small(tmp_path, name, n_items, **kw):
    train = SyntheticDataset(n_items=n_items, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    val = SyntheticDataset(n_items=4, n_mels=TINY.n_feats, seed=1, min_frames=16, max_frames=32)
    trainer = Trainer(TINY, TrainConfig(ckpt_dir=str(tmp_path / name), **kw), DATA, device="cpu")
    return trainer, trainer.fit(train, val, max_epochs=1, resume=False)


def test_profile_dir_traces_dispatches_2_to_3_and_closes_early(tmp_path):
    # 5 dispatches: one trace, closed after the 4th
    _, steps = _fit_small(tmp_path, "five", 20, profile_dir=str(tmp_path / "p5"))
    assert steps == 5
    traces = list((tmp_path / "p5").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("autograd" in str(e.get("name", "")).lower() or e.get("cat") == "cpu_op"
               for e in events)
    # 3 dispatches: the run ends before the 4th and closes the trace itself
    _, steps = _fit_small(tmp_path, "three", 12, profile_dir=str(tmp_path / "p3"))
    assert steps == 3
    assert len(list((tmp_path / "p3").glob("trace_*.json"))) == 1
    assert not torch.autograd.profiler._is_profiler_enabled
    # 1 dispatch: nothing traced, nothing left open
    _, steps = _fit_small(tmp_path, "one", 4, profile_dir=str(tmp_path / "p1"))
    assert steps == 1 and not (tmp_path / "p1").exists()
    assert not torch.autograd.profiler._is_profiler_enabled


def test_render_gating_and_cadence(tmp_path, monkeypatch):
    """No TensorBoard: the render path is not taken. With it: renders on the
    checkpoint cadence, the last epoch always; a failing render is printed
    and training goes on."""
    val = SyntheticDataset(n_items=2, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    trainer = Trainer(TINY, TrainConfig(ckpt_dir=str(tmp_path / "a")), DATA, device="cpu")

    def boom(*a, **kw):
        raise AssertionError("render path taken without TensorBoard")

    monkeypatch.setattr(Trainer, "_log_validation_images", boom)
    trainer.logger.tb_available = False
    assert trainer._maybe_render_validation(val, 0, 0, 5) is False

    called = []
    monkeypatch.setattr(Trainer, "_log_validation_images", lambda self, *a: called.append(a))
    trainer.logger.tb_available = True
    assert trainer._maybe_render_validation(val, 0, 0, 5) is True and called
    cfg4 = TrainConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every_epochs=4)
    trainer4 = Trainer(TINY, cfg4, DATA, device="cpu")
    trainer4.logger.tb_available = True
    assert trainer4._maybe_render_validation(val, 0, 0, 5) is False
    assert trainer4._maybe_render_validation(val, 3, 0, 5) is True
    assert trainer4._maybe_render_validation(val, 4, 0, 5) is True  # the last epoch
    assert trainer4._maybe_render_validation([], 3, 0, 5) is False


def test_validation_images_render_and_never_kill_training(tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    val = SyntheticDataset(n_items=2, n_mels=TINY.n_feats, min_frames=16, max_frames=32)
    images = []

    class FakeBoard:
        def add_image(self, tag, img, step, dataformats):
            images.append((tag, img.shape, img.dtype, dataformats))

    trainer = Trainer(TINY, TrainConfig(ckpt_dir=str(tmp_path / "r")), DATA, device="cpu")
    trainer.logger.tb = FakeBoard()
    trainer._log_validation_images(val, 0, 0, n_samples=1)
    tags = [t for t, *_ in images]
    assert tags == ["original/0", "generated_enc/0", "generated_dec/0", "alignment/0"]
    assert all(len(s) == 3 and s[2] == 3 and d == np.uint8 for _, s, d, _ in images)

    from matcha_tpu_torch.utils import plotting

    monkeypatch.setattr(plotting, "plot_tensor", lambda a: 1 / 0)
    trainer._log_validation_images(val, 1, 0)
    assert "validation image rendering failed" in capsys.readouterr().out


def test_mas_impl_names(tmp_path):
    for name in ("auto", "pallas", "ref"):
        Trainer(TINY, TrainConfig(ckpt_dir=str(tmp_path / name), mas_impl=name), DATA,
                device="cpu")
    for name, device in (("cpp", "cpu"), ("xla", "cpu"), ("ref", "meta")):
        with pytest.raises(ValueError, match="'auto' and 'pallas'"):
            Trainer(TINY, TrainConfig(ckpt_dir=str(tmp_path / "x"), mas_impl=name), DATA,
                    device=device)
    assert not (tmp_path / "x").exists()  # refused before touching the disk


def test_cli_trains_tiny_with_steps_per_dispatch_and_profile(tmp_path, capsys):
    from matcha_tpu_torch.cli.train import main

    main(["--tiny", "--max-epochs", "1", "--batch-size", "2", "--device", "cpu",
          "--ckpt-dir", str(tmp_path / "cli"), "--steps-per-dispatch", "2",
          "--profile", str(tmp_path / "prof")])
    assert "trained to step 8" in capsys.readouterr().out
    assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1


def test_step_timer_and_rtf_match_jax():
    for wall, frames in ((0.5, 100), (1.25, 861), (3.0, 1)):
        assert profiling.rtf(wall, frames) == jax_profiling.rtf(wall, frames)
    port, ref = profiling.StepTimer(), jax_profiling.StepTimer()
    for timer in (port, ref):
        for _ in range(3):
            with timer.measure() as out:
                out["result"] = {"loss": torch.ones(2)} if timer is port else jnp.ones(2)
    assert len(port.times) == len(ref.times) == 3
    port.times, ref.times = [3.0, 1.0, 2.0, 5.0], [3.0, 1.0, 2.0, 5.0]
    assert port.median == ref.median == 3.0
    assert np.isnan(profiling.StepTimer().median)
    assert profiling.synchronize([torch.ones(1), {"a": torch.zeros(2)}])[0].item() == 1.0

"""The port's training stack against the JAX package (CPU): optimizer, data, text,
checkpoints and the training loop.

- the optimizer follows the JAX trainer's optax chain (clip + adamw under
  MultiSteps(2)) update for update, at atol 1e-6 after every micro-step;
- synthetic items and the batch schedule are exactly the JAX pipeline's;
- the training tokenizer and cleaners give the JAX package's ids and text;
- checkpoints round-trip and keep the top-k plus the latest;
- `Trainer.fit` on the CPU writes metrics and checkpoints, and resuming gives
  the run that never stopped.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.audio.mel import MelConfig
from matcha_tpu.data import dataset as jax_data
from matcha_tpu.text import cleaners as jax_cleaners
from matcha_tpu.text import train_text_to_sequence as jax_train_text_to_sequence
from matcha_tpu.train import trainer as jax_trainer
from matcha_tpu_torch.data import dataset as port_data
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.text import english_cleaners, train_text_to_sequence
from matcha_tpu_torch.train.checkpoints import CheckpointStore
from matcha_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    chunk_batches_by_shape,
    make_lr_schedule,
    make_optimizer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- optimizer
def test_lr_schedule_matches_jax():
    """The JAX schedule computes in f32, the port in f64: equal to f32 precision
    (one f32 step of the peak rate, 2^-23 * 1e-4, near 1e-11)."""
    cfg = TrainConfig(lr=1e-4, eta_min=1e-6, cosine_epochs=100)
    port = make_lr_schedule(cfg, steps_per_epoch=10)
    jax_sched = jax_trainer.make_lr_schedule(jax_trainer.TrainConfig(
        lr=1e-4, eta_min=1e-6, cosine_epochs=100), steps_per_epoch=10)
    counts = [0, 5, 9, 10, 11, 99, 100, 499, 500, 999, 1000, 1001, 5000]
    np.testing.assert_allclose([port(c) for c in counts],
                               [float(jax_sched(c)) for c in counts], rtol=1e-6, atol=1e-11)
    assert port(5) == port(9) and port(10) < port(9)


@pytest.mark.parametrize("accumulate", [2, 1])
def test_optimizer_trajectory_matches_optax(accumulate):
    """Six micro-steps of the same random gradients, some past the clip norm;
    a short cosine so the learning rate moves between updates."""
    cfg = dict(lr=3e-2, eta_min=1e-3, cosine_epochs=3, weight_decay=1e-2,
               accumulate_steps=accumulate)
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.1, 2.0, 0.05, 3.0, 0.3, 0.2)]

    tx = jax_trainer.make_optimizer(jax_trainer.TrainConfig(**cfg), steps_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = make_optimizer(TrainConfig(**cfg), 1, list(params.values()))
    import optax

    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        emitted = opt.step([torch.from_numpy(g[k]) for k in params])
        assert emitted == ((i + 1) % accumulate == 0)
        for k in params:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"micro-step {i} {k}")
    assert opt.count == 6 // accumulate


def test_optimizer_state_round_trip():
    p = [torch.ones(3)]
    opt = make_optimizer(TrainConfig(), 4, p)
    opt.step([torch.full((3,), 0.5)])
    other = make_optimizer(TrainConfig(), 4, [torch.ones(3)])
    other.load_state_dict(opt.state_dict())
    assert other.mini_step == 1 and torch.equal(other.acc[0], opt.acc[0])


# ---------------------------------------------------------------- data and text
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_items_equal_jax(seed):
    port = port_data.SyntheticDataset(n_items=12, n_mels=80, seed=seed)
    ref = jax_data.SyntheticDataset(n_items=12, mel_cfg=MelConfig(), seed=seed)
    for i in range(12):
        a, b = port.get(i), ref.get(i)
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
        assert port.mel_length(i) == ref.mel_length(i)
        assert port.text_length(i) == ref.text_length(i)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_schedule_equals_jax(seed):
    """Two epochs of training batches, then the wrap-padded validation pass."""
    kw = dict(n_items=40, seed=seed, min_frames=30, max_frames=200)
    port = port_data.SyntheticDataset(n_mels=8, **kw)
    ref = jax_data.SyntheticDataset(mel_cfg=MelConfig(n_mels=8), **kw)
    pcfg = port_data.DataConfig(batch_size=6, shuffle_seed=seed)
    jcfg = jax_data.DataConfig(batch_size=6, shuffle_seed=seed)
    runs = [dict(epoch=0), dict(epoch=1), dict(epoch=0, shuffle=False, drop_last=False)]
    for kw in runs:
        got = list(port_data.batch_iterator(port, pcfg, **kw))
        want = list(jax_data.batch_iterator(ref, jcfg, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kw} {k}")
    for n in (0, 5, 40, 97, 1000):
        for drop in (True, False):
            assert port_data.num_batches(n, pcfg, drop_last=drop) == jax_data.num_batches(
                n, jcfg, drop_last=drop)


def test_collate_guards_the_mas_precondition():
    cfg = port_data.DataConfig()
    with pytest.raises(ValueError, match="mel_frames >= text_tokens"):
        port_data.collate([{"x": np.ones(10, np.int32), "y": np.zeros((4, 8), np.float32)}], cfg)
    assert port_data.pad_shapes(cfg, 45, 301) == jax_data.pad_shapes(jax_data.DataConfig(), 45, 301)


TEXTS = [
    "Mr. Smith has 2 cats", "Mr. Müller ate  2 Apples", "raison d'être", "grüß gott", "안녕",
    "Здравствуйте", "mr. and mrs. smith", "3 apples and 44 pears", "$3.50 for gas.",
    "Happy Birthday!", "CAFÉ", "1st", "243rd place", "September 11, 2001", "July 26, 1984.",
    "$135.99.", "for £2500!", "6.4 sec", "124,001", "$.01", "1800", "2010", " x.  y,  \tz",
    "Dr. Jekyll & Mr. Hyde, St. James's Co. Ltd.", "A {AW1 S}  B",
] + list(port_data.SyntheticDataset._SENTENCES)


def test_training_tokenizer_and_cleaners_equal_jax():
    assert port_data.SyntheticDataset._SENTENCES == jax_data.SyntheticDataset._SENTENCES
    for text in TEXTS:
        assert english_cleaners(text) == jax_cleaners.english_cleaners(text), text
        assert train_text_to_sequence(text) == jax_train_text_to_sequence(text), text
    assert english_cleaners("Mr. Müller ate  2 Apples") == "mister muller ate two apples"


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_and_top_k(tmp_path):
    model = MatchaTTS(tiny_config())
    store = CheckpointStore(tmp_path / "ckpts", keep_top_k=2)
    for step, epoch, loss in ((10, 1, 3.0), (20, 2, 2.0), (30, 3, 5.0), (40, 4, 4.0)):
        store.save(step, epoch, {"model": model.state_dict(), "optimizer": {"count": step}}, loss)
    assert store.best()["step"] == 20 and store.latest()["step"] == 40
    assert {e["step"] for e in store.entries} == {10, 20, 40}  # top-2 (2.0, 3.0) + latest
    assert not (tmp_path / "ckpts" / "step_000000030").exists()
    index = json.loads((tmp_path / "ckpts" / "index.json").read_text())
    assert set(index["entries"][0]) == {"step", "epoch", "val_loss", "path"}
    state, step, epoch = CheckpointStore(tmp_path / "ckpts").restore_latest()
    assert (step, epoch, state["optimizer"]["count"]) == (40, 4, 40)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state["model"][k], v, rtol=0, atol=0)
    best = store.restore_params()
    assert set(best) == set(model.state_dict())


def test_chunk_batches_by_shape_equals_jax():
    shapes = [(4, 3), (4, 5), (4, 3), (2, 2), (4, 5), (4, 3), (4, 3)]
    stream = [({"x": np.zeros(s)}, i) for i, s in enumerate(shapes)]
    for k in (1, 2, 3):
        got = [[aux for _, aux in c] for c in chunk_batches_by_shape(stream, k, window=4)]
        want = [[aux for _, aux in c] for c in jax_trainer.chunk_batches_by_shape(
            stream, k, window=4)]
        assert got == want


# ---------------------------------------------------------------- the loop
def _tiny_run(tmp_path, name, epochs, resume=True):
    cfg = tiny_config()
    data = port_data.DataConfig(batch_size=4, text_pad_multiple=16, mel_pad_multiple=16)
    train = port_data.SyntheticDataset(n_items=12, n_mels=cfg.n_feats, seed=0,
                                       min_frames=48, max_frames=80)
    val = port_data.SyntheticDataset(n_items=6, n_mels=cfg.n_feats, seed=1,
                                     min_frames=48, max_frames=80)
    trainer = Trainer(cfg, TrainConfig(ckpt_dir=str(tmp_path / name), log_every=1),
                      data, device="cpu")
    step = trainer.fit(train, val, max_epochs=epochs, resume=resume)
    return trainer, step


def test_fit_writes_metrics_and_checkpoints_and_resumes_exactly(tmp_path):
    straight, step = _tiny_run(tmp_path, "straight", 2)
    assert step == 6  # 3 micro-steps an epoch
    rows = [json.loads(line) for line in
            (tmp_path / "straight" / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in train_rows] == list(range(6))
    assert len(val_rows) == 2 and all(np.isfinite(r["val/loss"]) for r in val_rows)
    assert all(np.isfinite(r["train/grad_norm"]) for r in train_rows)
    index = json.loads((tmp_path / "straight" / "index.json").read_text())
    assert [e["step"] for e in index["entries"]] == [3, 6]
    assert straight.optimizer.count == 3  # one update per 2 micro-steps

    _tiny_run(tmp_path, "resumed", 1)
    resumed, step = _tiny_run(tmp_path, "resumed", 2)
    assert step == 6
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    for a, b in zip(straight.optimizer.state_dict()["mu"], resumed.optimizer.state_dict()["mu"]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_dropout_active_in_train_identity_in_eval():
    model = MatchaTTS(tiny_config())
    x = torch.randint(3, 100, (2, 16))
    xl = torch.tensor([16, 11])
    model.eval()
    with torch.no_grad():
        a, b = model.encoder(x, xl)[0], model.encoder(x, xl)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    model.train()
    with torch.no_grad():
        c, d = model.encoder(x, xl)[0], model.encoder(x, xl)[0]
    assert not torch.equal(c, d)
    # encoder p_dropout, dp_p_dropout and the prenet's 0.1; the U-Net's 0.05
    assert {m.p for m in model.modules() if isinstance(m, torch.nn.Dropout)} == {0.1, 0.05}


def test_cli_trains_tiny_on_cpu(tmp_path, capsys):
    from matcha_tpu_torch.cli.train import main

    main(["--tiny", "--max-epochs", "1", "--batch-size", "4", "--device", "cpu",
          "--ckpt-dir", str(tmp_path / "cli")])
    assert "trained to step 4" in capsys.readouterr().out
    assert (tmp_path / "cli" / "index.json").exists()

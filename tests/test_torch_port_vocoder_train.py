"""The port's vocoder data, trainer and CLI against the JAX package's behaviours
(CPU, tiny widths: `tests/test_vocoder_train.py`'s sizes).

- `SyntheticWavDataset`, `WavSegmentDataset` (a wav directory and a metadata
  file, utterances longer and shorter than a segment) and `wav_batch_iterator`
  (shuffled or not, tails dropped or wrap-padded, two processes) give the JAX
  package's batches bit for bit;
- K GAN steps in one dispatch equal K single dispatches (eager on the CPU,
  rtol 2e-5 / atol 1e-6, the bar of `test_vocoder_scan_dispatch_equals_
  sequential`), and `fit` logs the same trajectory at K = 1 and K = 2;
- `fit` counts steps, writes `metrics.jsonl` and `index.json`, checkpoints on
  its cadence and resumes onto the trajectory of an unbroken run (the JAX test
  `test_vocoder_trainer_fit_and_resume`);
- a trained generator, folded by `load_generator_for_inference`, serves as the
  training form computes (atol 1e-5), alone and inside a `TTSEngine`
  (the JAX test `test_trained_vocoder_serving_loop`, without a mesh);
- `cli.train_vocoder --tiny --device cpu`.
"""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from matcha_tpu.data import audio_dataset as jax_audio_dataset
from matcha_tpu_torch.data.audio_dataset import (
    AudioDataConfig,
    SyntheticWavDataset,
    WavSegmentDataset,
)
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from matcha_tpu_torch.train import trainer as trainer_module
from matcha_tpu_torch.train.vocoder import (
    METRICS,
    Discriminators,
    VocoderTrainConfig,
    VocoderTrainer,
    load_generator_for_inference,
)

SEG = 2048  # 8 mel frames at hop 256
TINY_GEN = HiFiGANConfig(upsample_initial_channel=16)
DATA = AudioDataConfig(batch_size=2, segment_size=SEG)


def tiny_disc():
    return Discriminators(mpd_channels=(4, 8),
                          msd_spec=((8, 15, 1, 1, 7), (8, 41, 4, 4, 20), (8, 5, 1, 1, 2)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Loggers without TensorBoard: its import costs seconds a process here."""
    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)


def _trainer(ckpt_dir, k=1, **cfg):
    return VocoderTrainer(TINY_GEN, VocoderTrainConfig(ckpt_dir=str(ckpt_dir), log_every=1,
                                                       steps_per_dispatch=k, **cfg),
                          DATA, disc=tiny_disc(), device="cpu")


def _train_rows(ckpt_dir):
    rows = [json.loads(line) for line in
            (ckpt_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if "train/g_loss" in r], [r for r in rows if "val/mel_l1" in r]


# ---------------------------------------------------------------------- data
def _write_wavs(root, lengths, rng):
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, n in enumerate(lengths):
        path = root / f"utt_{i}.wav"
        wavfile.write(path, 22050, (rng.uniform(-0.5, 0.5, n) * 32767).astype(np.int16))
        paths.append(str(path))
    return paths


def _batches(module, ds, cfg, **kw):
    return list(module.wav_batch_iterator(ds, cfg, **kw))


@pytest.mark.parametrize("kw", [
    dict(epoch=0), dict(epoch=3), dict(shuffle=False, drop_last=False),
    dict(epoch=1, drop_last=False, process_index=1, process_count=2)])
def test_batches_match_jax_bit_for_bit(tmp_path, kw):
    import matcha_tpu_torch.data.audio_dataset as port

    paths = _write_wavs(tmp_path / "wavs", [3000, 1500, 4096, 2048, 2049, 900, 5000],
                        np.random.default_rng(0))
    meta = tmp_path / "train.txt"
    meta.write_text("".join(f"{p}|some text\n" for p in paths[::-1]))
    for make in (lambda m: m.SyntheticWavDataset(n_items=7, segment_size=SEG, seed=3),
                 lambda m: m.WavSegmentDataset(tmp_path / "wavs", SEG),
                 lambda m: m.WavSegmentDataset(meta, SEG)):
        got = _batches(port, make(port), AudioDataConfig(batch_size=2, segment_size=SEG), **kw)
        want = _batches(jax_audio_dataset, make(jax_audio_dataset),
                        jax_audio_dataset.AudioDataConfig(batch_size=2, segment_size=SEG), **kw)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_wav_dataset_refuses_an_empty_source(tmp_path):
    with pytest.raises(ValueError, match="no wav files"):
        WavSegmentDataset(tmp_path)


# ------------------------------------------------------------------- trainer
def _segments(n_batches, seed=0):
    ds = SyntheticWavDataset(n_items=2 * n_batches, segment_size=SEG, seed=seed)
    rng = np.random.default_rng(0)
    return [np.stack([ds.get_segment(2 * i + j, rng) for j in range(2)])
            for i in range(n_batches)]


def test_k_steps_in_one_dispatch_equal_single_dispatches(tmp_path):
    batches = _segments(3)
    seq = _trainer(tmp_path / "a")
    seq.init_optimizers(steps_per_epoch=2)  # the lr decays after step 2
    one = torch.cat([seq.dispatch([b]) for b in batches])
    grouped = _trainer(tmp_path / "b")
    grouped.init_optimizers(steps_per_epoch=2)
    three = grouped.dispatch(batches)
    np.testing.assert_allclose(three.numpy(), one.numpy(), rtol=2e-5, atol=1e-6)
    for module in ("gen", "disc"):
        want = getattr(seq, module).state_dict()
        for key, val in getattr(grouped, module).state_dict().items():
            np.testing.assert_allclose(val.numpy(), want[key].numpy(), rtol=2e-5, atol=1e-6,
                                       err_msg=key)
    assert seq.eager_steps == grouped.eager_steps == 3  # the CPU runs eagerly
    assert seq.opt_g.count == grouped.opt_d.count == 3


def test_fit_trajectory_does_not_depend_on_k(tmp_path):
    train_ds = SyntheticWavDataset(n_items=10, segment_size=SEG)  # 5 steps an epoch
    logs = []
    for k in (1, 2):
        trainer = _trainer(tmp_path / f"k{k}", k=k)
        assert trainer.fit(train_ds, None, max_epochs=1) == 5
        logs.append(_train_rows(tmp_path / f"k{k}")[0])
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]] == list(range(5))
    for a, b in zip(*logs):
        for name in METRICS:
            np.testing.assert_allclose(b[f"train/{name}"], a[f"train/{name}"], rtol=2e-5,
                                       atol=1e-6)


def test_fit_checkpoints_and_resumes_onto_an_unbroken_run(tmp_path, capsys):
    train_ds = SyntheticWavDataset(n_items=4, segment_size=SEG)
    val_ds = SyntheticWavDataset(n_items=3, segment_size=SEG, seed=1)
    first = _trainer(tmp_path / "ck")
    assert first.fit(train_ds, val_ds, max_epochs=1) == 2  # 4 items / batch 2
    train_rows, val_rows = _train_rows(tmp_path / "ck")
    assert [r["step"] for r in train_rows] == [0, 1]
    assert set(train_rows[0]) >= {f"train/{m}" for m in METRICS}
    assert all(np.isfinite(r[f"train/{m}"]) for r in train_rows for m in METRICS)
    assert len(val_rows) == 1 and np.isfinite(val_rows[0]["val/mel_l1"])
    assert val_rows[0]["val/epoch_seconds"] > 0
    index = json.loads((tmp_path / "ck" / "index.json").read_text())
    assert [(e["step"], e["epoch"]) for e in index["entries"]] == [(2, 1)]

    resumed = _trainer(tmp_path / "ck")
    assert resumed.fit(train_ds, val_ds, max_epochs=2) == 4
    assert "resumed vocoder training from step 2 (epoch 1)" in capsys.readouterr().out
    unbroken = _trainer(tmp_path / "straight")
    assert unbroken.fit(train_ds, val_ds, max_epochs=2) == 4
    for module in ("gen", "disc"):
        want = getattr(unbroken, module).state_dict()
        for key, val in getattr(resumed, module).state_dict().items():
            np.testing.assert_allclose(val.numpy(), want[key].numpy(), rtol=1e-6, atol=1e-8,
                                       err_msg=key)
    assert resumed.opt_g.count == unbroken.opt_g.count == 4


def test_checkpoint_cadence_keeps_the_last_epoch(tmp_path):
    trainer = _trainer(tmp_path / "ck", ckpt_every_epochs=2)
    trainer.fit(SyntheticWavDataset(n_items=2, segment_size=SEG), None, max_epochs=3)
    index = json.loads((tmp_path / "ck" / "index.json").read_text())
    assert sorted(e["epoch"] for e in index["entries"]) == [2, 3]
    assert all(e["val_loss"] == float("inf") for e in index["entries"])  # no validation set


def test_trainer_refuses_a_segment_off_the_hop(tmp_path):
    with pytest.raises(ValueError, match="multiple of the hop"):
        VocoderTrainer(TINY_GEN, VocoderTrainConfig(ckpt_dir=str(tmp_path)),
                       AudioDataConfig(batch_size=2, segment_size=SEG + 1), device="cpu")


def test_trained_vocoder_serving_loop(tmp_path):
    """fit -> load_generator_for_inference -> the serving generator and engine."""
    trainer = _trainer(tmp_path / "vck")
    trainer.fit(SyntheticWavDataset(n_items=2, segment_size=SEG), None, max_epochs=1)
    folded = load_generator_for_inference(tmp_path / "vck")
    assert not any(k.endswith(("weight_g", "weight_v")) for k in folded)

    mel = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, SEG // 256, 80)).astype(np.float32))
    serving = Generator(TINY_GEN)
    serving.load_state_dict(folded)
    y_serving = serving(mel)
    y_train_form = trainer.gen(mel).detach()
    assert y_serving.shape == (1, SEG)
    np.testing.assert_allclose(y_serving.numpy(), y_train_form.numpy(), atol=1e-5, rtol=1e-5)

    mcfg = tiny_config(80)
    torch.manual_seed(0)
    model_sd = MatchaTTS(mcfg).state_dict()
    # ~2 frames a token, so that the text fits the 64-frame budget
    model_sd["encoder.duration_predictor.output_projection.bias"].fill_(0.7)
    engine = TTSEngine(model_sd, mcfg,
                       ServeConfig(n_timesteps=2, mel_budgets=(64,), vocoder="hifigan"),
                       vocoder_params=folded, hifigan_cfg=TINY_GEN, device="cpu")
    (wav,), info = engine.synthesise(["a trained vocoder"], seed=1)
    assert wav.dtype == np.float32 and wav.ndim == 1 and np.isfinite(wav).all()
    assert 0 < len(wav) <= 64 * 256 and not info["truncated"][0]


def test_cli_trains_tiny_on_cpu(tmp_path, capsys):
    from matcha_tpu_torch.cli.train_vocoder import main

    main(["--tiny", "--device", "cpu", "--epochs", "1", "--batch-size", "2",
          "--segment-size", str(SEG), "--steps-per-dispatch", "2",
          "--ckpt-dir", str(tmp_path / "cli")])
    assert "trained to step 4" in capsys.readouterr().out  # 8 items / batch 2
    assert (tmp_path / "cli" / "index.json").exists()
    train_rows, val_rows = _train_rows(tmp_path / "cli")
    assert [r["step"] for r in train_rows] == [0]  # log_every 10
    assert len(val_rows) == 1

"""The port's LJSpeech-format data path against the JAX package (CPU).

- `_wav_num_samples` and `TextMelDataset.mel_length` read the RIFF header as
  JAX's do (16-bit PCM, float32, extra chunks);
- `TextMelDataset` gives JAX's token ids, its log-mels within the mel bars of
  `test_torch_port_audio.py` (atol 1e-3 where the mel is above log(1e-3),
  2e-2 everywhere), the same cache file names, and the same batch schedule;
- `process_csv` writes JAX's `train.txt` and `val.txt`; `extract` unpacks;
- the CLI trains from an LJSpeech-format directory.
"""

import tarfile

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from matcha_tpu.audio.mel import MelConfig as JaxMelConfig
from matcha_tpu.data import dataset as jax_data
from matcha_tpu.data import ljspeech as jax_lj
from matcha_tpu_torch.data import dataset as port_data
from matcha_tpu_torch.data import ljspeech as port_lj

SR = 22050
TEXTS = ["The birch canoe slid on the smooth planks.", "Four hours of steady work faced us.",
         "Glue the sheet to the dark blue background.", "Mr. Smith has 2 cats",
         "It is easy to tell the depth of a well.", "Open the door.", "The sun is out today."]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speechlike(n: int, seed: int) -> np.ndarray:
    """A few harmonics under a slow envelope plus broadband noise, in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    y = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6)) / h for h in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
    return (0.25 * y * env + 0.05 * rng.standard_normal(n)).clip(-0.5, 0.5).astype(np.float32)


def _with_list_chunk(path):
    """Insert a LIST chunk between fmt and data, as tagging tools do."""
    raw = bytearray(path.read_bytes())
    pos = raw.index(b"data")
    chunk = b"LIST" + (6).to_bytes(4, "little") + b"INFOab"
    raw[pos:pos] = chunk
    raw[4:8] = (len(raw) - 8).to_bytes(4, "little")
    path.write_bytes(bytes(raw))


@pytest.fixture(scope="module")
def ljspeech_dir(tmp_path_factory):
    """An LJSpeech-format directory: metadata.csv and wavs/ of 7 short files
    (int16 PCM, one float32, one with a LIST chunk)."""
    root = tmp_path_factory.mktemp("lj") / "LJSpeech-1.1"
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i, text in enumerate(TEXTS):
        name = f"LJ001-{i:04d}"
        y = _speechlike(int(SR * (0.6 + 0.15 * i)), i)
        path = root / "wavs" / f"{name}.wav"
        if i == 1:
            wavfile.write(path, SR, y)  # float32 samples
        else:
            wavfile.write(path, SR, np.round(y * 32767).astype(np.int16))
        if i == 2:
            _with_list_chunk(path)
        lines.append(f"{name}|{text}|{text.lower()}")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def test_wav_header_lengths_equal_jax(ljspeech_dir):
    for path in sorted((ljspeech_dir / "wavs").glob("*.wav")):
        n = port_data._wav_num_samples(path)
        assert n == jax_data._wav_num_samples(path) == len(wavfile.read(path)[1])
    bad = ljspeech_dir / "not_a.wav"
    bad.write_bytes(b"RIFX0000WAVE")
    with pytest.raises(ValueError, match="RIFF"):
        port_data._wav_num_samples(bad)


def test_process_csv_writes_jax_splits(ljspeech_dir, tmp_path):
    counts = port_lj.process_csv(ljspeech_dir.parent, output_dir=tmp_path / "port")
    want = jax_lj.process_csv(ljspeech_dir.parent, output_dir=tmp_path / "jax")
    assert counts == want and sum(counts) == len(TEXTS)
    for name in ("train.txt", "val.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert port_lj._find_base(ljspeech_dir.parent) == ljspeech_dir
    with pytest.raises(FileNotFoundError):
        port_lj._find_base(tmp_path / "port")


def test_extract_unpacks_a_tarball(ljspeech_dir, tmp_path):
    tar = tmp_path / "lj.tar.bz2"
    with tarfile.open(tar, "w:bz2") as tf:
        tf.add(ljspeech_dir, arcname="LJSpeech-1.1")
    out = port_lj.extract(tar, tmp_path / "out")
    assert (out / "LJSpeech-1.1" / "metadata.csv").read_text() == \
        (ljspeech_dir / "metadata.csv").read_text()
    assert len(list((out / "LJSpeech-1.1" / "wavs").glob("*.wav"))) == len(TEXTS)


def _metadata(ljspeech_dir, tmp_path):
    meta = tmp_path / "all.txt"
    meta.write_text("".join(f"{ljspeech_dir / 'wavs' / f'LJ001-{i:04d}.wav'}|{t}\n"
                            for i, t in enumerate(TEXTS)))
    return meta


def test_text_mel_dataset_equals_jax(ljspeech_dir, tmp_path):
    meta = _metadata(ljspeech_dir, tmp_path)
    port = port_data.TextMelDataset(meta, cache_dir=tmp_path / "port_cache")
    ref = jax_data.TextMelDataset(meta, JaxMelConfig(), cache_dir=tmp_path / "jax_cache")
    assert len(port) == len(ref) == len(TEXTS)
    for i in range(len(port)):
        a, b = port.get(i), ref.get(i)
        np.testing.assert_array_equal(a["x"], b["x"])
        assert a["y"].dtype == np.float32 and a["y"].shape == b["y"].shape
        assert a["y"].shape == (port.mel_length(i), 80)
        loud = b["y"] > np.log(1e-3)
        assert loud.mean() > 0.5
        np.testing.assert_allclose(a["y"][loud], b["y"][loud], atol=1e-3)
        np.testing.assert_allclose(a["y"], b["y"], atol=2e-2)
        assert port.mel_length(i) == ref.mel_length(i)
        assert port.text_length(i) == ref.text_length(i)
    names = sorted(p.name for p in (tmp_path / "port_cache").glob("*.npy"))
    assert names == sorted(p.name for p in (tmp_path / "jax_cache").glob("*.npy"))
    assert len(names) == len(TEXTS)
    # a second read comes from the cache, unchanged
    again = port_data.TextMelDataset(meta, cache_dir=tmp_path / "port_cache")
    np.testing.assert_array_equal(again.get(3)["y"], port.get(3)["y"])


def test_text_mel_batches_equal_jax(ljspeech_dir, tmp_path):
    """The batch schedule of a TextMelDataset: JAX's keys, shapes and ids,
    mels within the mel bar."""
    meta = _metadata(ljspeech_dir, tmp_path)
    port = port_data.TextMelDataset(meta, cache_dir=tmp_path / "pc")
    ref = jax_data.TextMelDataset(meta, JaxMelConfig(), cache_dir=tmp_path / "jc")
    pcfg, jcfg = port_data.DataConfig(batch_size=2), jax_data.DataConfig(batch_size=2)
    for kw in (dict(epoch=0), dict(epoch=0, shuffle=False, drop_last=False)):
        got = list(port_data.batch_iterator(port, pcfg, **kw))
        want = list(jax_data.batch_iterator(ref, jcfg, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in ("x", "x_lengths", "y_lengths", "n_real"):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a["y"], b["y"], atol=2e-2)


def test_cli_reads_an_ljspeech_directory(ljspeech_dir, tmp_path, capsys, monkeypatch):
    """--data-dir: the split is written on first use and the full-width trainer
    starts on it (0 epochs: the CPU would take long over a full-width step)."""
    import shutil

    from matcha_tpu_torch.cli.train import main
    from matcha_tpu_torch.train import trainer as trainer_module

    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)  # seconds to import
    data = tmp_path / "LJSpeech-1.1"
    shutil.copytree(ljspeech_dir, data)
    main(["--data-dir", str(data), "--max-epochs", "0", "--batch-size", "2",
          "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--mas-impl", "ref"])
    out = capsys.readouterr().out
    assert "generating train/val split" in out and "trained to step 0" in out
    lines = (data / "train.txt").read_text().splitlines() + \
        (data / "val.txt").read_text().splitlines()
    assert len(lines) == len(TEXTS)


def test_fit_trains_on_a_text_mel_dataset(ljspeech_dir, tmp_path, monkeypatch):
    """An epoch of `Trainer.fit` on TextMelDataset items (a reduced-width model
    at the data's 80 mels): finite losses, the mel cache filled."""
    import json

    from matcha_tpu_torch.models.matcha import tiny_config
    from matcha_tpu_torch.train import trainer as trainer_module
    from matcha_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)
    meta = _metadata(ljspeech_dir, tmp_path)
    train = port_data.TextMelDataset(meta, cache_dir=tmp_path / "cache")
    trainer = Trainer(tiny_config(80), TrainConfig(ckpt_dir=str(tmp_path / "ck"), log_every=1),
                      port_data.DataConfig(batch_size=2), device="cpu")
    assert trainer.fit(train, train, max_epochs=1) == 3  # 7 items, batch 2
    rows = [json.loads(line) for line in
            (tmp_path / "ck" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "train/loss" in r] == [0, 1, 2]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if "loss" in k)
    assert len(list((tmp_path / "cache").glob("*.npy"))) == len(TEXTS)

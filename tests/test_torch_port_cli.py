"""The port's entry points on the CPU (`--device cpu`), against the calls they make
and against the JAX package's CLIs.

- `generate` at full width (2 ODE steps, a short text, the golden e2e weights
  in a Lightning checkpoint), with HiFi-GAN (a weight-normed `generator_v1`
  file) and with Griffin-Lim: its wav equals, after PCM16,
  `encode_durations` -> `decode_fixed` -> the vocoder with a generator seeded
  the same; without matplotlib the PNG is skipped and the wav still written;
- `serve` on 3 texts, plain, `--int16`, `--low-latency` and `--concurrent`:
  each wav equals the engine's direct call with the same seed (concurrent,
  with HiFi-GAN: the worker batches the requests as they arrive, so each is
  held against its solo synthesis within tests/test_torch_port_serve.py's
  bar, 1e-3; Griffin-Lim on these loud random mels amplifies a batch's other
  summation order past it);
- `bench_mas` at one small shape; `vocoder_report` on a full-width vocoder
  store (its mel L1 against the JAX package's `mel_l1` on the same pairs);
  `analyze` against `matcha_tpu.cli.analyze` on one `MetricLogger` log;
- the download utilities on `file://` URLs and local archives, and
  `ljspeech.prepare` on a pre-placed 12-clip tarball against the JAX split.
"""

import io
import json
import sys
import tarfile
import zipfile
from pathlib import Path
from urllib.error import URLError

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.cli import analyze, bench_mas, generate, serve, vocoder_report
from matcha_tpu_torch.compat.torch_import import (
    load_hifigan_torch_checkpoint,
    load_matcha_torch_checkpoint,
)
from matcha_tpu_torch.data import download, ljspeech
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from matcha_tpu_torch.text import simple_text_to_sequence
from matcha_tpu_torch.train.checkpoints import CheckpointStore
from tests.golden_utils import synth_state_dict

FIXDIR = Path(__file__).parent / "fixtures"
TEXT = "Hello there, world."
TEXTS = ["Hello there.", "The quick brown fox.", "Open the door, please."]
HOP = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcm16(wav) -> np.ndarray:
    """What `save_wav` stores for a float waveform."""
    return (np.clip(np.asarray(wav), -1.0, 1.0) * 32767).astype(np.int16)


def _read(path) -> np.ndarray:
    sr, data = wavfile.read(path)
    assert sr == 22050 and data.dtype == np.int16
    return data


def _weight_normed_generator(cfg, seed=0):
    """A `generator_v1`-format state dict (weight_g/weight_v), fan-in scaled."""
    out = {}
    state = Generator(cfg, weight_norm=True).state_dict()
    for idx, (key, val) in enumerate(sorted(state.items())):
        n = np.random.default_rng([seed, idx]).standard_normal(tuple(val.shape))
        if key.endswith("weight_v"):
            arr = n / np.sqrt(np.prod(val.shape[1:]))
        elif key.endswith("weight_g"):
            arr = 1.0 + 0.05 * n
        else:
            arr = 0.02 * n
        out[key] = torch.from_numpy(arr.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(matcha .ckpt, generator_v1 file): the full-width golden e2e weights and a
    full-width weight-normed HiFi-GAN v1."""
    root = tmp_path_factory.mktemp("ckpts")
    fx = np.load(FIXDIR / "golden_e2e.npz")
    spec = {k[len("spec/"):]: tuple(fx[k]) for k in fx.files if k.startswith("spec/")}
    sd = {k: torch.from_numpy(v) for k, v in synth_state_dict(spec).items()}
    torch.save({"state_dict": sd, "epoch": 1}, root / "matcha.ckpt")
    torch.save({"generator": _weight_normed_generator(HiFiGANConfig())}, root / "generator_v1")
    return root / "matcha.ckpt", root / "generator_v1"


@pytest.mark.parametrize("vocoder", ["hifigan", "griffin_lim"])
def test_generate_equals_the_model_calls(ckpts, tmp_path, capsys, monkeypatch, vocoder):
    ckpt, gen_path = ckpts
    argv = ["--text", TEXT, "--torch-ckpt", str(ckpt), "--steps", "2", "--seed", "3",
            "--vocoder", vocoder, "--out-dir", str(tmp_path), "--device", "cpu"]
    if vocoder == "hifigan":
        argv += ["--hifigan-ckpt", str(gen_path)]
    else:  # as on a machine without matplotlib: the PNG is skipped, the wav written
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    generate.main(argv)
    printed = capsys.readouterr().out

    model = MatchaTTS(MatchaConfig()).eval()
    load_matcha_torch_checkpoint(ckpt, model)
    seq = simple_text_to_sequence(TEXT)
    gen = torch.Generator().manual_seed(3)
    enc = model.encode_durations(torch.tensor([seq]), torch.tensor([len(seq)]))
    out = model.decode_fixed(*enc, fix_len_compatibility(int(enc[3].max())), 2, 1.0,
                             generator=gen)
    n = int(out["mel_lengths"][0])
    mel = out["mel"][:, :n]
    if vocoder == "hifigan":
        wav = torch.clamp(load_hifigan_torch_checkpoint(gen_path)(mel), -1.0, 1.0)
    else:
        wav = mel_to_audio(MelConfig(), mel.transpose(1, 2), generator=gen)
    got = _read(tmp_path / f"matcha_{vocoder}.wav")
    assert got.shape == (n * HOP,)
    np.testing.assert_array_equal(got, _pcm16(wav[0].numpy()))
    assert f"mel: (1, {n}, 80), rtf=" in printed and "saved" in printed
    png = tmp_path / "mel_spectrogram.png"
    assert png.exists() == (vocoder == "hifigan")
    assert (f"{png} skipped" in printed) == (vocoder != "hifigan")


def test_generate_hifigan_needs_a_generator(ckpts):
    with pytest.raises(SystemExit, match="needs --hifigan-ckpt"):
        generate.main(["--vocoder", "hifigan", "--torch-ckpt", str(ckpts[0]),
                       "--device", "cpu"])


@pytest.mark.parametrize("mode", ["plain", "int16", "low_latency", "concurrent"])
def test_serve_equals_the_engine(ckpts, tmp_path, capsys, mode):
    hifigan = ["--vocoder", "hifigan", "--hifigan-ckpt", str(ckpts[1])]
    flags = {"plain": [], "int16": ["--int16"], "low_latency": ["--low-latency"],
             "concurrent": ["--concurrent", *hifigan]}[mode]
    serve.main(["--texts", *TEXTS, "--torch-ckpt", str(ckpts[0]), "--steps", "2",
                "--mel-budgets", "64", "128", "--seed", "5", "--out-dir", str(tmp_path),
                "--device", "cpu", *flags])
    printed = capsys.readouterr().out
    got = [_read(tmp_path / f"utt_{i:03d}.wav") for i in range(len(TEXTS))]
    assert f"batch of {len(TEXTS)}: budget=" in printed

    cfg = ServeConfig(n_timesteps=2, mel_budgets=(64, 128), max_batch=16,
                      output_dtype="int16" if mode == "int16" else "float32",
                      vocoder="hifigan" if mode == "concurrent" else "griffin_lim")
    gen = load_hifigan_torch_checkpoint(ckpts[1]).state_dict() if mode == "concurrent" else None
    engine = TTSEngine(load_matcha_torch_checkpoint(ckpts[0]), cfg=cfg, vocoder_params=gen,
                       device="cpu")
    if mode in ("plain", "int16"):
        want, _ = engine.synthesise(TEXTS, seed=5)
    elif mode == "low_latency":
        want = [engine.synthesise_lowlatency(t, seed=5 + i)[0] for i, t in enumerate(TEXTS)]
        assert printed.count("low-latency: ") == len(TEXTS)
    else:
        want = [engine.synthesise([t], seeds=[5 + i])[0][0] for i, t in enumerate(TEXTS)]
        assert "concurrent: group sizes" in printed
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if mode == "int16":
            np.testing.assert_array_equal(g, w)
        elif mode == "concurrent":
            np.testing.assert_allclose(g / 32767, w, atol=1e-3 + 1 / 32767)
        else:
            np.testing.assert_array_equal(g, _pcm16(w))


def test_bench_mas_on_the_cpu(monkeypatch, capsys):
    from matcha_tpu.cli.bench_mas import make_problem as jax_make_problem

    for got, want in zip(bench_mas.make_problem(4, 20, 60, seed=2),
                         jax_make_problem(4, 20, 60, seed=2)):
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(bench_mas, "SHAPES", [(3, 12, 30)])
    monkeypatch.setattr(bench_mas, "RUNS", 2)
    bench_mas.main(["--device", "cpu"])  # asserts plain == cpp bit for bit
    printed = capsys.readouterr().out
    assert "plain_vs_cpp" in printed and "(3, 12, 30)" in printed


def test_vocoder_report_against_jax_mel_l1(tmp_path, capsys):
    from matcha_tpu.audio.mel import MelConfig as JaxMelConfig
    from matcha_tpu.cli.vocoder_report import mel_l1 as jax_mel_l1
    from matcha_tpu_torch.data.audio_dataset import SyntheticWavDataset

    gsd = _weight_normed_generator(HiFiGANConfig(), seed=1)
    CheckpointStore(tmp_path / "voc").save(4, 1, {"model": {"gen": gsd}}, 1.0)
    out = tmp_path / "report.json"
    vocoder_report.main(["--synthetic", "--n", "2", "--segment-size", "8192",
                         "--vocoder-ckpt-dir", str(tmp_path / "voc"), "--out", str(out),
                         "--device", "cpu"])
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report["paths"]
    assert report["n"] == 2 and report["segment_size"] == 8192
    assert report["source"] == "synthetic"
    assert set(report["paths"]) == {"griffin_lim", "hifigan_trained"}

    cfg = MelConfig()
    ds = SyntheticWavDataset(n_items=2, segment_size=8192, seed=1)
    gen = Generator(HiFiGANConfig())
    gen.load_state_dict(gsd)  # folded on load
    for i in range(2):
        y = ds.get_segment(i, np.random.default_rng(0))
        log_mel = torch.from_numpy(y[None])
        from matcha_tpu_torch.audio.mel import mel_spectrogram

        log_mel = mel_spectrogram(cfg, log_mel)
        recs = {"griffin_lim": mel_to_audio(cfg, log_mel,
                                            generator=torch.Generator().manual_seed(i))[0],
                "hifigan_trained": torch.clamp(gen(log_mel.transpose(1, 2)), -1, 1)[0]}
        for path, y_rec in recs.items():
            y_rec = y_rec.numpy()
            port = vocoder_report.mel_l1(cfg, y, y_rec)
            assert abs(port - jax_mel_l1(JaxMelConfig(), y, y_rec)) <= 1e-4
            assert report["paths"][path]["mel_l1_per_item"][i] == round(port, 4)


def _metric_log(log_dir, with_epoch):
    from matcha_tpu_torch.train.trainer import MetricLogger

    logger = MetricLogger(log_dir, use_tensorboard=False)
    rng = np.random.default_rng(0)
    step = 0
    for epoch in range(3):
        for _ in range(4):
            step += 1
            vals = {k: float(rng.uniform(0.5, 2)) for k in ("dur_loss", "prior_loss", "diff_loss")}
            vals["loss"] = sum(vals.values())
            logger.log(step, vals, prefix="train/", epoch=epoch if with_epoch else None)
        vals = {k: float(rng.uniform(0.5, 2)) for k in ("dur_loss", "prior_loss", "diff_loss")}
        vals["loss"] = sum(vals.values())
        logger.log(step, vals, prefix="val/", epoch=epoch if with_epoch else None)
    logger.close()


@pytest.mark.parametrize("with_epoch", [True, False])
def test_analyze_writes_the_jax_csvs(tmp_path, monkeypatch, with_epoch):
    import pandas as pd

    from matcha_tpu.cli import analyze as jax_analyze

    log_dir = tmp_path / "logs"
    _metric_log(log_dir, with_epoch)
    analyze.main(["--log-dir", str(log_dir), "--out-dir", str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["analyze", "--log-dir", str(log_dir),
                                      "--out-dir", str(tmp_path / "jax")])
    jax_analyze.main()
    for name in ("val_losses.csv", "all_metrics.csv", "epoch_losses.csv"):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port" / name),
                                      pd.read_csv(tmp_path / "jax" / name))
    assert len(pd.read_csv(tmp_path / "port" / "epoch_losses.csv")) == 3
    for png in ("loss_curves.png", "loss_curves_epoch.png"):
        assert (tmp_path / "port" / png).stat().st_size > 0


def test_download_pretrained_model_from_file_urls(tmp_path):
    src = tmp_path / "generator_v1.src"
    src.write_bytes(b"weights")
    dest = tmp_path / "out" / "generator_v1"
    assert download.download_pretrained_model(src.as_uri(), dest) == dest
    assert dest.read_bytes() == b"weights"
    src.write_bytes(b"changed")  # present: not fetched again
    assert download.download_pretrained_model(src.as_uri(), dest).read_bytes() == b"weights"
    missing = tmp_path / "out" / "matcha_final.ckpt"
    with pytest.raises(URLError):
        download.download_pretrained_model((tmp_path / "nothing").as_uri(), missing)
    assert not missing.exists() and not list((tmp_path / "out").glob("*.partial"))
    assert download.MATCHA_CKPT_URL.endswith("/matcha_final.ckpt")
    assert download.HIFIGAN_V1_URL.endswith("/generator_v1")


def test_ljspeech_download_from_file_urls(tmp_path):
    src = tmp_path / "src.tar.bz2"
    src.write_bytes(b"tarball")
    got = ljspeech.download(tmp_path / "dl" / "LJSpeech-1.1.tar.bz2", url=src.as_uri())
    assert got.read_bytes() == b"tarball"
    with pytest.raises(URLError):
        ljspeech.download(tmp_path / "dl2" / "x.tar.bz2", url=(tmp_path / "none").as_uri())
    assert not list((tmp_path / "dl2").iterdir())  # no partial file left


@pytest.mark.parametrize("kind", ["zip", "tar.bz2"])
def test_extract_archive(tmp_path, kind):
    files = {"a/b.txt": b"one", "c.txt": b"two"}
    archive = tmp_path / f"arch.{kind}"
    if kind == "zip":
        with zipfile.ZipFile(archive, "w") as zf:
            for name, data in files.items():
                zf.writestr(name, data)
    else:
        with tarfile.open(archive, "w:bz2") as tf:
            for name, data in files.items():
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    out = download.extract_archive(archive, tmp_path / "out")
    for name, data in files.items():
        assert (out / name).read_bytes() == data
    with pytest.raises(ValueError, match="unknown archive format"):
        download.extract_archive(tmp_path / "arch.rar", tmp_path / "out")


def test_prepare_gives_the_jax_split(tmp_path):
    from matcha_tpu.data import ljspeech as jax_ljspeech

    save = tmp_path / "save"
    save.mkdir()
    with tarfile.open(save / ljspeech.URL.rsplit("/", 1)[-1], "w:bz2") as tf:
        lines = "".join(f"LJ001-{i:04d}|Text number {i}.|Text number {i}.\n" for i in range(12))
        for name, data in [("LJSpeech-1.1/metadata.csv", lines.encode())] + [
                (f"LJSpeech-1.1/wavs/LJ001-{i:04d}.wav", b"RIFF") for i in range(12)]:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    counts = ljspeech.prepare(tmp_path / "port", save_dir=save)
    assert counts == jax_ljspeech.prepare(tmp_path / "jax", save_dir=save)
    assert sum(counts) == 12
    for split in ("train.txt", "val.txt"):
        port = (tmp_path / "port" / "LJSpeech-1.1" / split).read_text()
        ref = (tmp_path / "jax" / "LJSpeech-1.1" / split).read_text()
        assert port == ref.replace(str(tmp_path / "jax"), str(tmp_path / "port"))

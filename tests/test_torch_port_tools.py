"""The port's counterparts of the JAX package's last tools, on the CPU at tiny widths.

- `cli.trace_train_step`: its attribution of a traced eager micro-step by
  (module, op, shapes), on a CPU trace (host ops) and on a made-up trace of
  the card's form (kernels, their launch calls, autograd nodes and the
  profiler's forward-backward flows);
- `cli.profile_vocoder --device cpu`: a trace and a table whose rows sum to
  its total;
- `cli.train_mfu_sweep`'s child at tiny width: the remat variants and
  `no_accum` against `base`, and the variants without a counterpart;
- the port's `compute_losses` gradients under `DecoderConfig.remat` "full"
  and "dots" against the JAX package's under the same remat (the harness of
  `tests/test_torch_port_losses.py`, noise injected, the JAX decoder's
  attention through its Pallas kernel in interpret mode);
- the text and mel walkthroughs against the JAX package's functions on the
  notebooks' inputs.
"""

import importlib.util
import json
import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu import text as jax_text
from matcha_tpu.audio.mel import MelConfig as JaxMelConfig
from matcha_tpu.audio.mel import mel_spectrogram as jax_mel_spectrogram
from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.matcha import tiny_config as jax_tiny_config
from matcha_tpu.text.cmudict import CMUDict as JaxCMUDict
from matcha_tpu_torch.cli import profile_vocoder, trace_train_step, train_mfu_sweep
from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.train import trainer
from tests.test_torch_port_losses import _batch, _check_losses, _port_losses, jax_losses

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """The trainers' metric loggers without TensorBoard, whose import takes
    seconds here."""
    monkeypatch.setattr(trainer, "_tb_importable", lambda: False)


@pytest.fixture
def small_batch(monkeypatch):
    """The trace tool's fixed batch at Tx 8, Ty 32."""
    monkeypatch.setattr(trace_train_step, "TX", 8)
    monkeypatch.setattr(trace_train_step, "TY", 32)


# ------------------------------------------------------------ trace_train_step
def test_attribution_of_a_cpu_eager_micro_step(tmp_path, capsys, no_tensorboard, small_batch):
    res = trace_train_step.main([str(tmp_path), "--device", "cpu", "--tiny", "--batch", "2",
                                 "--k", "1", "--eager-attribution"])
    out = capsys.readouterr().out
    att = res["attribution"]
    assert att["where"] == "host" and "by layer" in out
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert len(list((tmp_path / "eager").glob("trace_*.json"))) == 1
    rows = att["rows"]
    assert rows and all(r["module"] and r["op"] for r in rows)
    assert sum(r["ms"] for r in rows) == pytest.approx(att["total_ms"], rel=1e-9)
    assert {r["pass"] for r in rows} == {"forward", "backward"}
    convs = [r for r in rows if r["op"] == "aten::conv1d"]
    assert convs and all(re.fullmatch(r"B=2 C=\d+ L=\d+ Cout=\d+ k=\d+ groups=1", r["shapes"])
                         for r in convs)
    # a convolution's backward is named by its node beside its forward op and shapes
    back = [r for r in rows if r["op"] == "ConvolutionBackward0 of aten::conv1d"]
    assert back and all(r["shapes"].startswith("B=2 ") and r["module"] != "(backward)"
                        for r in back)
    assert res["eager_launches"] == {"attention_fwd": 0, "attention_bwd": 0, "mas": 0}


def _op(name, tid, ts, dur, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _launch(tid, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": tid,
            "ts": ts, "dur": 2, "args": {"correlation": corr}}


def _kernel(name, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": 1000 + corr,
            "dur": dur, "args": {"correlation": corr}}


def test_attribution_of_kernels_by_launch_node_and_flow():
    """A made-up trace of the card's form: a forward convolution inside its
    module's range (an FFT kernel), its backward on another thread linked to
    it by a flow, a backward node with no flow, and a kernel with no launch."""
    dims = [[128, 192, 64], [768, 192, 3], [768], [], [], [], []]
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "encoder.ffn.conv_1", "pid": 1, "tid": 1,
         "ts": 0, "dur": 100, "args": {}},
        _op("aten::conv1d", 1, 10, 80, **{"Input Dims": dims,
                                          "Concrete Inputs": ["", "", "", "[1]", "[1]", "[1]",
                                                              "1"]}),
        _op("aten::convolution", 1, 12, 70),
        _launch(1, 20, 7),
        _kernel("void fft1d_r2c_32<float, float, float2, true, false>", 50.0, 7),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 3, "pid": 1, "tid": 1, "ts": 12},
        _op("autograd::engine::evaluate_function: ConvolutionBackward0", 2, 200, 100),
        _op("ConvolutionBackward0", 2, 201, 98),
        {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 3, "pid": 1, "tid": 2, "ts": 201,
         "bp": "e"},
        _op("aten::convolution_backward", 2, 202, 96),
        _launch(2, 210, 8),
        _kernel("sm90_xmma_dgrad_f32f32_f32f32", 30.0, 8),
        _op("autograd::engine::evaluate_function: AddBackward0", 2, 400, 10),
        _launch(2, 402, 9),
        _kernel("void at::native::vectorized_elementwise_kernel<4>()", 5.0, 9),
        _kernel("some_kernel", 1.0, 99),
    ]
    att = trace_train_step.attribute(events)
    shapes = "B=128 C=192 L=64 Cout=768 k=3 groups=1"
    rows = {(r["module"], r["op"], r["shapes"], r["pass"]): r for r in att["rows"]}
    assert set(rows) == {
        ("encoder.ffn.conv_1", "aten::conv1d", shapes, "forward"),
        ("encoder.ffn.conv_1", "ConvolutionBackward0 of aten::conv1d", shapes, "backward"),
        ("(backward)", "AddBackward0", "", "backward"),
        ("(unlinked)", "(other)", "", "")}
    fwd = rows[("encoder.ffn.conv_1", "aten::conv1d", shapes, "forward")]
    assert fwd["fft_kernels"] == 1 and fwd["fft_ms"] == pytest.approx(0.05)
    assert att["where"] == "device" and att["total_ms"] == pytest.approx(0.086)
    assert att["fft_ms"] == pytest.approx(0.05) and att["fft_without_shapes"] == 0
    assert trace_train_step.op_shapes(_op("aten::conv_transpose1d", 1, 0, 1, **{
        "Input Dims": [[4, 256, 10], [256, 128, 4], [128], [], [], [], [], []],
        "Concrete Inputs": ["", "", "", "[2]", "[1]", "[0]", "1", "[1]"]})) == \
        "B=4 C=256 L=10 Cout=128 k=4 groups=1"


# ------------------------------------------------------------- profile_vocoder
def test_profile_vocoder_on_the_cpu_prints_rows_that_sum_to_the_total(tmp_path, capsys):
    res = profile_vocoder.main(["--device", "cpu", "--tiny", "--batch", "2", "--frames", "16",
                                "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert "up=conv_transpose res=K2" in out[0] and res["out"].shape == (2, 16 * 256)
    total = float(re.match(r"host total \(4 replays\): ([\d.]+) ms", out[1]).group(1))
    groups = out[out.index("by kernel group:") + 1:out.index("by kernel:")]
    printed = [float(line.split()[0]) for line in groups]
    assert len(printed) == len(res["by_group"]) and total > 0
    # the total is printed to 0.01 ms, the rows to 0.001 ms
    assert sum(printed) == pytest.approx(total, abs=5e-3 + 5e-4 * len(printed))
    assert sum(res["by_group"].values()) == pytest.approx(res["total_ms"], rel=1e-9)


# ------------------------------------------------------------- train_mfu_sweep
def _child(name):
    return train_mfu_sweep.child(dict(train_mfu_sweep.BASE, **train_mfu_sweep.VARIANTS[name],
                                      iters=1, batch=2, tx=8, ty=32, device="cpu", tiny=True))


def test_sweep_children_hold_against_base(no_tensorboard):
    rows = {n: _child(n) for n in ("base", "remat_full", "remat_dots", "no_accum")}
    base = rows["base"]["first_metrics"]
    for name in ("remat_full", "remat_dots"):
        got = rows[name]["first_metrics"]
        for key, want in base.items():
            assert got[key] == pytest.approx(want, rel=1e-6, abs=1e-12), (name, key)
    assert rows["no_accum"]["first_metrics"]["loss"] == base["loss"]
    for r in rows.values():
        assert r["mfu_k8"] is None  # no card, no peak: never a CPU number under a device metric
        assert r["train_step_ms_k8"] > 0 and r["step_flops"] > 0
    # the products of the recompute are counted under remat
    assert rows["remat_full"]["step_flops"] > rows["base"]["step_flops"]
    assert set(train_mfu_sweep.NO_COUNTERPART) == {"attn_xla", "lhs_flag", "aggressive_fusion"}
    assert set(train_mfu_sweep.VARIANTS) == {"base", "remat_full", "remat_dots", "no_accum",
                                            "cudnn_benchmark", "cudnn_benchmark_remat_dots"}


def test_sweep_writes_one_row_a_variant_and_its_header(tmp_path, monkeypatch, no_tensorboard):
    def in_process(name, cfg, device, timeout_s=0):
        if cfg.get("cudnn_benchmark"):  # a child that failed
            return {"variant": name, **cfg, "error": "RuntimeError: a search inside a capture"}
        return {"variant": name, **cfg, **_child(name)}

    monkeypatch.setattr(train_mfu_sweep, "run_variant", in_process)
    out = tmp_path / "sweep.json"
    train_mfu_sweep.main(["--device", "cpu", "--tiny", "--only", "base,cudnn_benchmark",
                          "--out", str(out)])
    written = json.loads(out.read_text())
    assert written["device"] == "cpu" and written["power_limit_w"] is None
    assert written["no_counterpart"] == train_mfu_sweep.NO_COUNTERPART
    assert [r["variant"] for r in written["rows"]] == ["base", "cudnn_benchmark"]
    assert "error" in written["rows"][1] and "error" not in written["rows"][0]
    benchmark = torch.backends.cudnn.benchmark
    _child("cudnn_benchmark")
    assert torch.backends.cudnn.benchmark == benchmark  # the setting is the child's alone


# ------------------------------------------------------- remat parity with JAX
@pytest.fixture(scope="module")
def tiny_params():
    """The tiny model's JAX parameters (dropout 0; the prenet projection
    given weights, as in tests/test_torch_port_losses.py); the tree does not
    depend on remat."""
    jcfg = jax_tiny_config()
    jcfg = replace(jcfg, decoder=replace(jcfg.decoder, attn_impl="pallas", dropout=0.0),
                   encoder=replace(jcfg.encoder, p_dropout=0.0, dp_p_dropout=0.0))
    params = jax.tree.map(np.asarray, init_params(JaxMatcha(jcfg), jax.random.PRNGKey(0),
                                                  tx=8, ty=16))
    pre = params["encoder"]["ConvReluNorm_0"]["Dense_0"]
    pre["kernel"] = 0.1 * np.random.default_rng(0).standard_normal(
        pre["kernel"].shape).astype(np.float32)
    return jcfg, params


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_match_jax(tiny_params, remat):
    jcfg, params = tiny_params
    jcfg = replace(jcfg, decoder=replace(jcfg.decoder, remat=remat))
    cfg = tiny_config()
    model = MatchaTTS(replace(cfg, decoder=replace(cfg.decoder, remat=remat))).eval()
    model.load_state_dict(matcha_state_dict_from_jax(params))
    arrays = _batch(1, 3, 12, 32, 8, [12, 9, 5], [32, 27, 20])
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_losses(p, jcfg, *arrays), has_aux=True))(params)
    out = _port_losses(model, arrays)
    _check_losses(out, want)
    model.zero_grad()
    (out["dur_loss"] + out["prior_loss"] + out["diff_loss"]).backward()
    want_grads = matcha_state_dict_from_jax(jax.tree.map(np.asarray, grads))
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    for key, w in want_grads.items():
        g, w = got_grads[key].numpy(), w.numpy()
        ref = max(np.abs(w).max(), 1e-12)
        np.testing.assert_allclose(g / ref, w / ref, atol=1e-4, err_msg=key)


# ---------------------------------------------------------------- walkthroughs
def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_text_walkthrough_matches_the_jax_text_frontend(capsys):
    walk = _example("walkthrough_text_torch")
    res = walk.main([])
    assert "round trip:" in capsys.readouterr().out
    cmu = JaxCMUDict()
    full = jax_text.text_to_sequence(walk.ARPABET_TEXT, ["english_cleaners"])
    assert res["cleaned"] == jax_text.english_cleaners(walk.CLEANER_TEXT)
    assert res["lookup"] == {w: cmu.lookup(w) for w in walk.LOOKUP_WORDS}
    assert res["full"] == full and res["round_trip"] == jax_text.sequence_to_text(full)
    assert "{HH AW1 S S T AH0 N}" in res["round_trip"]
    assert res["simple"] == jax_text.simple_text_to_sequence(walk.SIMPLE_TEXT)
    assert res["train"] == jax_text.train_text_to_sequence(walk.SIMPLE_TEXT)


def test_mel_walkthrough_matches_the_jax_log_mel(tmp_path):
    walk = _example("walkthrough_mel_torch")
    image = tmp_path / "mel.png"
    res = walk.main(["--out", str(image)])
    want = np.asarray(jax_mel_spectrogram(JaxMelConfig(), jnp.asarray(res["wav"][None])))
    assert res["log_mel"].shape == want.shape == (1, 80, 86)
    # the mel itself within 1e-5; its log within 1e-5 where the mel is above
    # 1e-2: near the log's floor (1e-5) the log magnifies the two FFTs' float32
    # rounding (up to 3e-3 there)
    np.testing.assert_allclose(np.exp(res["log_mel"]), np.exp(want), atol=1e-5, rtol=0)
    loud = want > np.log(1e-2)
    assert loud.sum() > 500
    np.testing.assert_allclose(res["log_mel"][loud], want[loud], atol=1e-5, rtol=0)
    if importlib.util.find_spec("matplotlib") is not None:
        assert res["image"] == str(image) and image.stat().st_size > 0

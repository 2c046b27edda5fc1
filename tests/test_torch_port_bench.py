"""The port's bench (`matcha_tpu_torch.bench`), its load curve and its trace table on the CPU.

- `main` prints one JSON line holding every key of the JAX bench's result
  (read from the root `bench.py` with `ast`, which is not imported);
- the closed-loop serving row reports the engine's own `max_batch` and fills
  groups (the counterpart of tests/test_serve.py's bench test);
- the product count is linear in batch and in ODE steps, and lies between
  half of XLA's cost analysis of the JAX decoder and all of it (XLA also
  counts elementwise work);
- the MAS inside `compute_losses` equals the C++ MAS; a training row returns
  finite times at K 1 and 8 and honours `out_size`;
- `cli.serve_load_curve` writes a row a level and appends tagged rows;
- `cli.trace_table` sums a Chrome trace's kernel events by group.
Tiny widths, torch on one thread, `device="cpu"`.
"""

import ast
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from matcha_tpu.nn.decoder import Decoder as JaxDecoder
from matcha_tpu.nn.decoder import DecoderConfig as JaxDecoderConfig
from matcha_tpu_torch import bench
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.cli import bench_mas, serve_load_curve, trace_table
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS, tiny_config
from matcha_tpu_torch.nn.decoder import DecoderConfig
from matcha_tpu_torch.serve import ServeConfig, TTSEngine
from matcha_tpu_torch.utils.profiling import product_flops

ROOT = Path(__file__).resolve().parents[1]
TINY80 = tiny_config(80)
# the bench's shapes cut for the CPU: every row of `--fast` at these
SMALL = {"headline_batch": 4, "parity_batch": 2, "tuned_batch": 4, "fused_batch": 8,
         "tx": 16, "ty": 64, "mas": ((2, 10, 40), (3, 15, 60))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_result_keys():
    """The keys of the `result` dict in the root bench.py's main, by ast."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "result" for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in bench.py's main")


def test_main_prints_every_key_of_the_jax_bench(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "SHAPES", SMALL)
    monkeypatch.setattr(bench_mas, "RUNS", 2)
    rc = bench.main(["--fast", "--tiny", "--device", "cpu", "--profile", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, lines
    result = json.loads(lines[0])
    keys = _jax_result_keys()
    assert len(keys) == 32
    assert set(keys) <= set(result), set(keys) - set(result)
    assert {"device", "power_limit_w"} <= set(result)
    assert result["backend"] == "cpu" and result["device"] == "cpu"
    assert result["batch"] == SMALL["headline_batch"] and result["precision"] == "bf16"
    assert result["value"] > 0 and result["fp32_x_realtime"] > 0
    assert result["mfu"] is None  # no card, no peak: never a CPU number under a device metric
    assert result["mas_paths_equal"] is True and result["mas_fused_paths_equal"] is True
    assert set(result["mas_shapes"]) == {"2x10x40", "3x15x60"}
    assert result["failed_rows"] == []
    # the headline's replays traced, readable by the trace table
    assert len(list((tmp_path / "synthesis").glob("trace_*.json"))) == 1
    trace_table.aggregate(tmp_path / "synthesis")


def test_a_failed_row_is_null_and_the_run_exits_1(monkeypatch, capsys):
    """A row that raises leaves its key null and the run exits 1: no row
    error is swallowed by a run that exits 0."""
    monkeypatch.setattr(bench, "SHAPES", SMALL)
    monkeypatch.setattr(bench_mas, "RUNS", 2)

    def broken(*args, **kwargs):
        raise RuntimeError("no fused check")

    monkeypatch.setattr(bench, "mas_fused_check", broken)
    rc = bench.main(["--fast", "--tiny", "--device", "cpu"])
    captured = capsys.readouterr()
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert rc == 1 and result["mas_fused_paths_equal"] is None
    assert result["failed_rows"] == ["mas fused check"]
    assert "no fused check" in captured.err


def test_bench_serve_latency_closed_loop_fills_groups():
    """Closed-loop clients keep the batching queue fed, so groups hold more
    than one request, and a passed engine's own max_batch is warmed and
    reported (not the default argument's 8)."""
    cfg = tiny_config(8)
    scfg = ServeConfig(n_timesteps=2, mel_budgets=(32,), max_batch=4, vocoder="griffin_lim",
                       mel_cfg=MelConfig(n_mels=8))
    eng = TTSEngine(bench.init_model(cfg).state_dict(), cfg, scfg, device="cpu")
    row = bench.bench_serve_latency(n_requests=12, threads=4, eng=eng, closed_loop=True)
    assert row["n"] == 12 and row["threads"] == 4
    assert row["max_batch"] == 4
    assert row["mean_group_size"] > 1.0
    assert row["requests_per_s"] > 0 and row["p50"] >= row["wall_p50"] * 0.5


def test_flop_count_is_linear_in_batch_and_steps():
    one = bench.estimator_flops(TINY80, 64)
    assert one > 0 and bench.estimator_flops(TINY80, 64, batch=3) == 3 * one
    model = bench.init_model(TINY80).eval()
    x = torch.randint(3, 140, (2, 16))
    xl = torch.full((2,), 16)

    def synthesis(n):
        with torch.no_grad():
            return product_flops(model.synthesise_fixed, x, xl, 64, n,
                                 generator=torch.Generator().manual_seed(0))

    # the encoder's products once, then one estimator call a step
    assert synthesis(4) - synthesis(2) == 2 * 2 * one
    assert synthesis(3) - synthesis(2) == 2 * one
    step = bench.train_step_flops(TINY80, 16, 64)
    assert step > 3 * one and bench.train_step_flops(TINY80, 16, 64, batch=2) == 2 * step


def _xla_decoder_flops(cfg, ty, n_feats):
    """XLA's cost analysis of one JAX Decoder forward at batch 1 (the root
    bench.py's `_estimator_flops`)."""
    dec = JaxDecoder(cfg)
    xt = jnp.zeros((1, ty, n_feats))
    mask = jnp.ones((1, ty, 1))
    tt = jnp.full((1,), 0.5)
    params = dec.init(jax.random.PRNGKey(0), xt, mask, xt, tt, deterministic=True)["params"]
    f = jax.jit(lambda p: dec.apply({"params": p}, xt, mask, xt, tt, deterministic=True))
    ca = f.lower(params).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_product_count_within_xla_cost_analysis(width):
    """Products only, so at most XLA's count, and at least half of it. At
    full width, batch 1, Ty 512 the ratio is the one PERF.md records."""
    if width == "tiny":
        kw = dict(in_channels=16, out_channels=8, channels=(16, 16), attention_head_dim=8,
                  num_heads=2, num_mid_blocks=1)
        mcfg = dataclasses.replace(tiny_config(8), decoder=DecoderConfig(**kw))
        jcfg, ty = JaxDecoderConfig(**kw), 64
    else:
        mcfg, jcfg, ty = MatchaConfig(), JaxDecoderConfig(), 512
    ours = bench.estimator_flops(mcfg, ty)
    xla = _xla_decoder_flops(jcfg, ty, mcfg.n_feats)
    print(f"{width}: products {ours} / XLA {xla:.0f} = {ours / xla:.4f}")
    assert 0.5 * xla <= ours <= xla


def test_mas_fused_check_on_cpu():
    assert bench.mas_fused_check(batch=8, device="cpu", mcfg=TINY80) is True


def test_bench_train_times_both_dispatches_and_honours_out_size(monkeypatch):
    seen = []
    compute_losses = MatchaTTS.compute_losses

    def recording(self, *args, **kwargs):
        seen.append(kwargs.get("out_size"))
        return compute_losses(self, *args, **kwargs)

    monkeypatch.setattr(MatchaTTS, "compute_losses", recording)
    kw = dict(batch=2, tx=8, ty=32, k=8, iters=1, device="cpu", mcfg=TINY80)
    t1, t8, k, flops = bench.bench_train(**kw)
    assert k == 8 and all(math.isfinite(t) and t > 0 for t in (t1, t8)) and flops > 0
    # 2 + 1 dispatches of one micro-step, 2 of eight, the counted step; no crop
    assert seen == [None] * (3 + 16 + 1)
    seen.clear()
    c1, c8, _, cropped = bench.bench_train(out_size=16, **kw)
    assert math.isfinite(c1) and math.isfinite(c8)
    assert seen == [16] * (3 + 16 + 1)
    assert cropped < flops  # the decoder ran on 16 of 32 frames


def test_serve_load_curve_writes_a_row_a_level_and_appends(tmp_path, capsys):
    out = tmp_path / "curve.json"
    base = ["--tiny", "--device", "cpu", "--per-thread", "2", "--max-batch", "2",
            "--mel-budgets", "32"]
    serve_load_curve.main(base + ["--threads", "1", "2", "--out", str(out)])
    curve = json.loads(out.read_text())
    assert [r["threads"] for r in curve["rows"]] == [1, 2]
    assert all(r["n_requests"] == 16 and r["requests_per_s"] > 0 and r["mean_group_size"] >= 1
               and r["p99_ms"] >= r["p50_ms"] for r in curve["rows"])
    assert curve["config"]["max_batch"] == 2 and curve["config"]["mel_budgets"] == [32]
    assert curve["device"] == "cpu"
    serve_load_curve.main(base + ["--threads", "4", "--append-to", str(out)])
    rows = json.loads(out.read_text())["rows"]
    assert len(rows) == 3 and "max_batch" not in rows[0]
    assert rows[2]["threads"] == 4 and rows[2]["max_batch"] == 2
    assert rows[2]["mel_budgets"] == [32] and rows[2]["zero_sync"] is True
    assert '"n_new": 1' in capsys.readouterr().out


def test_trace_table_sums_kernel_events_by_group(tmp_path, capsys):
    def kernel(name, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "dur": dur, "ts": 0, "pid": 0}

    events = [kernel("void attn_fwd_kernel<float, 64>(Params)", 100.0),
              kernel("void attn_fwd_kernel<float, 64>(Params)", 60.0),
              kernel("void attn_bwd_dq_kernel<__nv_bfloat16>(Params)", 40.0),
              kernel("mas_path_kernel", 20.0),
              kernel("void mrf_step_kernel<float>(Args)", 80.0),
              kernel("sm90_xmma_gemm_bf16bf16_bf16f32", 30.0),
              kernel("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", 2.0),
              kernel("void at::native::vectorized_elementwise_kernel<4>()", 50.0),
              kernel("void at::native::RowwiseMomentsCUDAKernel<float>()", 10.0),
              kernel("void at::native::reduce_kernel<512, 1>()", 5.0),
              kernel("void vector_fft<256>()", 4.0),
              kernel("some_other_kernel", 1.0),
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 999.0, "ts": 0},
              {"ph": "i", "cat": "kernel", "name": "attn_fwd marker", "ts": 0}]
    (tmp_path / "trace_1_1.json").write_text(json.dumps({"traceEvents": events}))
    groups, _, total = trace_table.aggregate(tmp_path)
    ms = {g: round(v[0], 6) for g, v in groups.items()}
    assert ms == {"K1 attention_fwd": 0.16, "K4 attention_bwd": 0.04, "K3a+K3b mas": 0.02,
                  "K2 mrf_step": 0.08, "matmul": 0.032, "elementwise": 0.05,
                  "normalization": 0.01, "reduction": 0.005, "fft": 0.004, "other": 0.001}
    assert groups["K1 attention_fwd"][1] == 2 and abs(total - 0.402) < 1e-9
    trace_table.main([str(tmp_path / "trace_1_1.json"), "--dispatches", "2"])
    out = capsys.readouterr().out
    assert "0.402 ms over 2 dispatch(es), 0.201 ms each" in out
    assert "     0.080 ms/disp  39.8%      1.0 kernels  K1 attention_fwd" in out

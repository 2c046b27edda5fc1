"""The port's serving engine on the CPU: tiny Matcha with a reduced HiFi-GAN,
or with Griffin-Lim (the default vocoder) at 8 mels.

HiFi-GAN engine:
- `synthesise(seeds=...)` equals the port's model + generator run by hand on the
  same `torch.Generator` noise;
- a request's waveform does not depend on its batch mates;
- int16 output is round(clip(wav) * 32767) of the float32 output;
- truncation past the largest budget is flagged;
- `synthesise_lowlatency` runs at a fixed budget.
Griffin-Lim engine, the behaviours of tests/test_serve.py held on the port:
- the decode stage against the JAX package's model and `mel_to_audio` on
  weights carried by `compat/jax_params.py`, with the same noise and phase;
- thread-safe `synthesise`, batched `serve()` equal to solo synthesis, the
  worker's refusals and partial failure, low-latency equal to two-stage, int16,
  truncation flags, and zero-sync dispatch with one budget;
- the stage keys (power-of-two batch, text bucket, budget) each path selects.
Also the tokenizer copy against the JAX package's.
"""

import dataclasses
import queue
import threading
import warnings

import numpy as np
import pytest
import torch

from matcha_tpu_torch.audio.griffin_lim import mel_to_audio
from matcha_tpu_torch.audio.mel import MelConfig
from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.ops.masks import fix_len_compatibility
from matcha_tpu_torch.serve import ServeConfig, TTSEngine, _Request, pow2
from matcha_tpu_torch.text import simple_text_to_sequence, symbols


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU thread pool oversubscribes the test workers' cores and
    runs these small convolutions many times slower; one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tiny_config()
HCFG = HiFiGANConfig(upsample_initial_channel=32, num_mels=8)
HOP = 256
TEXTS = ["hello world", "flow matching is fast", "abc"]


@pytest.fixture(scope="module")
def weights():
    torch.manual_seed(0)
    model_sd = MatchaTTS(CFG).state_dict()
    # ~2 frames per token, so the texts land in the 32- and 64-frame budgets
    model_sd["encoder.duration_predictor.output_projection.bias"].fill_(0.7)
    return model_sd, Generator(HCFG).state_dict()


def _engine(weights, mel_budgets=(32, 64, 128), **kw):
    cfg = ServeConfig(n_timesteps=2, mel_budgets=mel_budgets, max_batch=4, vocoder="hifigan",
                      **kw)
    return TTSEngine(weights[0], CFG, cfg, weights[1], HCFG, device="cpu")


@pytest.fixture(scope="module")
def engine(weights):
    return _engine(weights)


def test_synthesise_matches_model_and_generator(engine):
    """Same ids, same per-seed noise: the engine adds nothing but packing.
    Exact: the same CPU ops in the same order on both sides."""
    seeds = [11, 12]
    wavs, info = engine.synthesise(TEXTS[:2], seeds=seeds)
    budget = info["budget"]
    x, xl = engine._tokenize(TEXTS[:2])
    z = torch.stack([torch.randn((budget, CFG.n_feats),
                                 generator=torch.Generator().manual_seed(s)) for s in seeds])
    out = engine.model.synthesise_fixed(x, xl, budget, 2, z=z)
    want = torch.clamp(engine.vocoder(out["mel"]), -1, 1).numpy()
    assert info["mel_lengths"] == out["mel_lengths"].tolist()
    for i, wav in enumerate(wavs):
        assert wav.dtype == np.float32 and wav.shape == (info["mel_lengths"][i] * HOP,)
        np.testing.assert_array_equal(wav, want[i, : wav.shape[0]])


def test_request_independent_of_batch_mates(weights):
    """One budget, so every request decodes at 64 frames alone or batched.
    Tolerance 1e-5: the batch pads the text to another length, so the
    encoder's masked convs and softmaxes sum over other (zero) padding."""
    engine = _engine(weights, mel_budgets=(64,))
    batch, info = engine.synthesise(TEXTS, seeds=[5, 6, 7])
    assert not any(info["truncated"])
    for i, (text, seed) in enumerate(zip(TEXTS, [5, 6, 7])):
        solo, _ = engine.synthesise([text], seeds=[seed])
        np.testing.assert_allclose(solo[0], batch[i], atol=1e-5)


def test_int16_output_is_quantized_float(weights, engine):
    f32, info = engine.synthesise(TEXTS[:2], seeds=[3, 4])
    i16, info16 = _engine(weights, output_dtype="int16").synthesise(TEXTS[:2], seeds=[3, 4])
    assert info16["mel_lengths"] == info["mel_lengths"]
    for a, b in zip(f32, i16):
        assert b.dtype == np.int16
        np.testing.assert_array_equal(b, np.round(np.clip(a, -1, 1) * 32767).astype(np.int16))


def test_truncation_is_flagged(weights):
    eng = TTSEngine(weights[0], CFG, ServeConfig(n_timesteps=1, mel_budgets=(8,),
                                                 vocoder="hifigan"),
                    weights[1], HCFG, device="cpu")
    with pytest.warns(UserWarning, match="truncated"):
        wavs, info = eng.synthesise(["a much longer sentence than eight frames", "a"],
                                    seeds=[1, 2])
    assert info["budget"] == 8 and info["truncated"] == [True, False]
    assert wavs[0].shape == (8 * HOP,)
    with pytest.warns(UserWarning, match="truncated"):
        _, info = eng.synthesise_lowlatency("a much longer sentence", seed=1)
    assert info["truncated"] is True


def test_lowlatency_at_fixed_budget(engine):
    wav, info = engine.synthesise_lowlatency(TEXTS[0], seed=9, budget=64)
    assert info["budget"] == 64 and not info["truncated"]
    assert wav.shape == (info["mel_lengths"][0] * HOP,) and np.isfinite(wav).all()
    # the same request through the two-stage path, when it picks the same budget
    wavs, info2 = engine.synthesise([TEXTS[0]], seeds=[9])
    if info2["budget"] == 64:
        np.testing.assert_allclose(wavs[0], wav, atol=1e-6)


def test_tokenizer_matches_jax_package():
    from matcha_tpu.text import simple_text_to_sequence as jax_tok
    from matcha_tpu.text.symbols import symbols as jax_symbols

    assert symbols == jax_symbols and len(symbols) == 150
    for text in TEXTS + ["Hello, World! It's 3 o'clock; café?"]:
        assert simple_text_to_sequence(text) == jax_tok(text)


# ------------------------------------------------------------ Griffin-Lim engine
MEL8 = MelConfig(n_mels=8)
# The tiny random model's log-mel spans about [-7, 7], e^7 times louder than
# speech, whose log-mels lie in about [-11.5, 2]; mel_mean -8 moves it into
# speech's range, so the waveform has speech's amplitude (|y| < 1) and the JAX
# tests' Griffin-Lim bar, 1e-3 absolute at that amplitude, means what it says.
# Griffin-Lim is homogeneous: a louder mel scales waveform and error alike.
GL_MEL_MEAN = -8.0
GL_CFG = dataclasses.replace(CFG, mel_mean=GL_MEL_MEAN)


def _gl_engine(weights, mel_budgets=(32, 64, 128), **kw):
    cfg = ServeConfig(n_timesteps=2, mel_budgets=mel_budgets, max_batch=4, mel_cfg=MEL8, **kw)
    return TTSEngine(weights[0], GL_CFG, cfg, device="cpu")


@pytest.fixture(scope="module")
def gl_engine(weights):
    return _gl_engine(weights)


def test_griffin_lim_is_the_default_vocoder(weights):
    assert ServeConfig().vocoder == "griffin_lim" and ServeConfig().max_wait_ms == 5.0
    eng = _gl_engine(weights)
    assert eng.vocoder is None
    with pytest.raises(ValueError, match="mels"):  # 80 mels for an 8-feature model
        TTSEngine(weights[0], CFG, ServeConfig(), device="cpu")


def test_griffin_lim_synthesise_matches_model_and_mel_to_audio(gl_engine):
    """Per-seed draws: the noise, then the phase, from one generator per
    request; the engine adds nothing but Griffin-Lim on exp(mel) and packing.
    Exact: the same CPU ops in the same order on both sides."""
    seeds = [11, 12]
    wavs, info = gl_engine.synthesise(TEXTS[:2], seeds=seeds)
    budget = info["budget"]
    x, xl = gl_engine._tokenize(TEXTS[:2])
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    z = torch.stack([torch.randn((budget, CFG.n_feats), generator=g) for g in gens])
    phase = torch.stack([torch.rand((513, budget), generator=g) * (2 * np.pi) - np.pi
                         for g in gens])
    mel = gl_engine.model.synthesise_fixed(x, xl, budget, 2, z=z)["mel"]
    want = mel_to_audio(MEL8, mel.transpose(1, 2), phase=phase).numpy()
    for i, wav in enumerate(wavs):
        assert wav.dtype == np.float32 and wav.shape == (info["mel_lengths"][i] * HOP,)
        np.testing.assert_array_equal(wav, want[i, : wav.shape[0]])


def test_griffin_lim_slice_matches_jax(weights):
    """The slice against the JAX package: its encoder, `decode_fixed` and
    `mel_to_audio` on JAX `init` parameters, and the port engine's stages on
    the same parameters carried by `compat/jax_params.py`, with the same noise
    and the JAX phase injected, at `GL_MEL_MEAN`. Bars: the mel's of the
    port's model parity (1e-4, two f32 implementations summing in other
    orders) and the waveform's of tests/test_serve.py (1e-3, after
    Griffin-Lim's 32 iterations)."""
    import importlib

    import jax
    import jax.numpy as jnp

    from matcha_tpu.models import matcha as jm
    from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax

    jgl = importlib.import_module("matcha_tpu.audio.griffin_lim")
    jmel = importlib.import_module("matcha_tpu.audio.mel")
    jmodel = jm.MatchaTTS(dataclasses.replace(jm.tiny_config(), mel_mean=GL_MEL_MEAN))
    params = jm.init_params(jmodel, jax.random.PRNGKey(3))
    sd = matcha_state_dict_from_jax(jax.tree.map(np.asarray, params))
    eng = TTSEngine(sd, GL_CFG, ServeConfig(n_timesteps=3, mel_budgets=(64,), mel_cfg=MEL8),
                    device="cpu")

    texts, budget = ["hello world", "flow matching"], 64
    x, xl = eng._tokenize(texts)
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, budget, 8)).astype(np.float32)
    phase = np.array(jax.random.uniform(jax.random.PRNGKey(9), (2, 513, budget),
                                        minval=-np.pi, maxval=np.pi))
    enc = jax.jit(lambda p, a, b: jmodel.apply({"params": p}, a, b,
                                               method=jm.MatchaTTS.encode_durations))(
        params, jnp.asarray(x.numpy(), jnp.int32), jnp.asarray(xl.numpy(), jnp.int32))
    out = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a, budget, 3, z=jnp.asarray(z),
                                             method=jm.MatchaTTS.decode_fixed))(params, *enc)
    jwav = np.asarray(jgl.mel_to_audio(jmel.MelConfig(n_mels=8), jnp.swapaxes(out["mel"], 1, 2),
                                       rng=jax.random.PRNGKey(9)))

    penc = eng._encode(x, xl)
    mel = eng.model.decode_fixed(*penc, budget, 3, z=torch.from_numpy(z))["mel"]
    np.testing.assert_allclose(mel.numpy(), np.asarray(out["mel"]), atol=1e-4)
    packed = eng._decode(budget, *penc, torch.from_numpy(z), torch.from_numpy(phase)).numpy()
    np.testing.assert_array_equal(packed[:, -2], np.asarray(out["mel_lengths"]))
    np.testing.assert_allclose(packed[:, :-2], jwav, atol=1e-3)


def test_engine_synthesise_thread_safe(gl_engine):
    """Concurrent synthesise() callers: the lock serializes each call's stages,
    so every threaded result is bit-equal to the same call made alone."""
    calls = [(["hello world"], 11), (["abc", "de fg"], 22), (["thread safety"], 33)]
    expected = [gl_engine.synthesise(texts, seed=s)[0] for texts, s in calls]
    results, errors = [None] * len(calls), []

    def run(i):
        try:
            for _ in range(3):
                results[i] = gl_engine.synthesise(calls[i][0], seed=calls[i][1])[0]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for got, want in zip(results, expected):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_serve_batching_deterministic(gl_engine):
    """Batched concurrent serve(): each request equals the same (text, seed)
    synthesised alone with seeds=. The group pads the text to another length,
    so the encoder sums over other zero padding (1e-5, as above), which
    Griffin-Lim's iterations amplify: the waveform bar of tests/test_serve.py,
    1e-3."""
    reqs = [("hello world", 1), ("abc", 2), ("some longer sentence here", 3), ("hi", 4)]
    expected = [gl_engine.synthesise([t], seeds=[s]) for t, s in reqs]
    gl_engine.start_batching(max_wait_ms=300)  # a long window: the requests group
    try:
        results = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def run(i):
            barrier.wait()
            results[i] = gl_engine.serve(reqs[i][0], seed=reqs[i][1])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        gl_engine.stop_batching()
    assert any(info["group_size"] > 1 for _, info in results), "requests never batched"
    assert len({info["budget"] for _, info in results}) == 2  # two budget sub-groups
    for (text, seed), (got, info), (want, want_info) in zip(reqs, results, expected):
        assert info["budget"] == want_info["budget"] and not info["truncated"]
        assert info["latency_s"] >= info["wall_s"] > 0
        assert got.shape == want[0].shape, (text, seed)
        np.testing.assert_allclose(got, want[0], atol=1e-3, rtol=1e-4,
                                   err_msg=f"{text!r} seed={seed}")


def test_serve_requires_worker(gl_engine):
    with pytest.raises(RuntimeError, match="start_batching"):
        gl_engine.serve("hello", seed=0)


def test_batch_worker_partial_failure_preserves_delivered(gl_engine, monkeypatch):
    """A failure in stage A fails only the requests not yet delivered or
    dispatched: a delivered waveform is never replaced by the error."""

    def fake_dispatch(reqs, out_q):
        reqs[0].wav = np.zeros(10, np.float32)
        reqs[0].info = {"budget": 32}
        reqs[0].event.set()
        raise RuntimeError("boom")

    monkeypatch.setattr(gl_engine, "_dispatch_group", fake_dispatch)
    gl_engine.start_batching(max_wait_ms=500)
    try:
        results, errors = {}, {}

        def call(i):
            try:
                results[i] = gl_engine.serve(f"text {i}", seed=i)
            except RuntimeError as e:
                errors[i] = e

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 1 and len(errors) == 1
        assert "boom" in str(next(iter(errors.values())))
    finally:
        monkeypatch.undo()
        gl_engine.stop_batching()


def test_serve_refuses_after_stop(gl_engine):
    gl_engine.start_batching()
    gl_engine.stop_batching()
    with pytest.raises(RuntimeError, match="start_batching"):
        gl_engine.serve("hello", seed=0)


def test_synthesise_lowlatency_matches_two_stage(gl_engine):
    """The one-stage low-latency path equals the two-stage path at the same
    budget: both draw the noise and then the phase from `manual_seed(11)`."""
    wavs, info = gl_engine.synthesise(["hello world"], seed=11)
    wav_ll, info_ll = gl_engine.synthesise_lowlatency("hello world", seed=11,
                                                      budget=info["budget"])
    assert info_ll["budget"] == info["budget"]
    assert info_ll["mel_lengths"] == info["mel_lengths"]
    np.testing.assert_allclose(wav_ll, wavs[0], atol=1e-3, rtol=1e-4)
    _, info_d = gl_engine.synthesise_lowlatency("hello world", seed=11)
    assert info_d["budget"] == max(gl_engine.cfg.mel_budgets)


def test_engine_int16_output_mode(weights, gl_engine):
    """int16 Griffin-Lim output: round(clip(wav, -1, 1) * 32767) of the float32
    engine's output, computed on the device side."""
    wf, inf = gl_engine.synthesise(["hello world"], seeds=[5])
    wi, ini = _gl_engine(weights, output_dtype="int16").synthesise(["hello world"], seeds=[5])
    assert wi[0].dtype == np.int16 and wf[0].dtype == np.float32
    assert inf["mel_lengths"] == ini["mel_lengths"]
    np.testing.assert_array_equal(
        wi[0], np.round(np.clip(wf[0], -1, 1) * 32767.0).astype(np.int16))


def test_engine_flags_truncation_past_largest_budget(weights):
    """A text predicting more frames than the largest budget comes back
    flagged (with a warning) from every entry point, the batching worker's
    included."""
    eng = _gl_engine(weights, mel_budgets=(32,))
    long_text = "this utterance is deliberately much longer than the budget " * 2
    with pytest.warns(UserWarning, match="truncated"):
        wavs, info = eng.synthesise([long_text, "hi"], seeds=[1, 2])
    assert info["truncated"] == [True, False] and info["mel_lengths"][0] == 32
    with pytest.warns(UserWarning, match="truncated"):
        _, info_ll = eng.synthesise_lowlatency(long_text, seed=3)
    assert info_ll["truncated"] is True
    assert eng.synthesise_lowlatency("hi", seed=3)[1]["truncated"] is False
    eng.start_batching(max_wait_ms=1)
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            _, rinfo = eng.serve(long_text, seed=4)
        assert rinfo["truncated"] is True
        assert any("truncated" in str(w.message) for w in rec)
        assert eng.serve("hi", seed=5)[1]["truncated"] is False
    finally:
        eng.stop_batching()


def test_single_budget_stage_a_reads_nothing_back(weights, monkeypatch):
    """With one budget, stage A dispatches without reading the predicted
    lengths (`_host_lengths` is its only read) and stage B flags truncation
    from the packed tail; with several budgets stage A must read them."""
    long_text = "this utterance is deliberately much longer than the budget " * 2
    one = _gl_engine(weights, mel_budgets=(32,))
    several = _gl_engine(weights)
    for eng in (one, several):
        monkeypatch.setattr(eng, "_host_lengths", lambda *a: pytest.fail("stage A read back"))
    out_q = queue.Queue()
    one._dispatch_group([_Request(long_text, 1), _Request("hi", 2)], out_q)
    host, done, reqs, idx, budget, y_pred, _, _ = out_q.get_nowait()
    assert done is None and y_pred is None and budget == 32 and idx == [0, 1]
    tail = host.numpy()[:, -2:]
    assert tail[0, 0] == 32 and tail[0, 1] > 32 and tail[1, 1] <= 32
    one.start_batching(max_wait_ms=1)
    try:
        with pytest.warns(UserWarning, match="truncated"):
            assert one.serve(long_text, seed=4)[1]["truncated"] is True
    finally:
        one.stop_batching()
    with pytest.raises(pytest.fail.Exception, match="stage A read back"):
        several._dispatch_group([_Request("hi", 2)], queue.Queue())


def test_stage_keys_and_budget_selection(gl_engine):
    """The stages each path selects: encode (batch, text bucket), decode
    (batch, text bucket, budget), low-latency (text bucket, budget); a serve
    group is padded to a power of two, and each budget sub-group with other
    rows than the group re-runs encode at its own batch."""
    assert [pow2(n) for n in (1, 2, 3, 4, 5, 9, 16)] == [1, 2, 4, 4, 8, 16, 16]
    cfg = gl_engine.cfg
    assert [cfg.text_bucket(n) for n in (0, 1, 16, 17, 300)] == [1, 16, 16, 32, 256]
    assert [gl_engine._pick_budget(f) for f in (1, 32, 33, 128, 999)] == [32, 32, 64, 128, 128]
    eng = TTSEngine(gl_engine.model.state_dict(), GL_CFG, cfg, device="cpu")
    _, info = eng.synthesise(["hello world", "abc"], seeds=[1, 2])
    assert set(eng._stages) == {("encode", 2, 16), ("decode", 2, 16, info["budget"])}
    eng.synthesise_lowlatency("flow matching is fast", seed=1, budget=64)
    assert ("lowlatency", 32, 64) in eng._stages
    eng._stages.clear()
    texts = ["hello world", "abc", "some longer sentence here"]
    out_q = queue.Queue()
    eng._dispatch_group([_Request(t, i) for i, t in enumerate(texts)], out_q)
    subgroups = [out_q.get_nowait() for _ in range(out_q.qsize())]
    y = eng._encode(*eng._tokenize(texts))[3].tolist()
    short, long_ = (eng._pick_budget(fix_len_compatibility(max(y[:2]))),
                    eng._pick_budget(fix_len_compatibility(y[2])))
    assert short < long_
    assert [(s[4], s[3]) for s in subgroups] == [(short, [0, 1]), (long_, [2])]
    assert set(eng._stages) == {("encode", 4, 32), ("encode", 2, 16), ("encode", 1, 32),
                                ("decode", 2, 16, short), ("decode", 1, 32, long_)}
    eng.warmup((1, 2), text="abc")
    assert {("decode", 2, 16, b) for b in cfg.mel_budgets} <= set(eng._stages)
    assert {("lowlatency", 16, b) for b in cfg.mel_budgets} <= set(eng._stages)

"""Data and tensor parallelism of the port against the JAX package (CPU, gloo ranks).

The port's ranks are processes (`tests/torch_ranks.py`); the JAX side runs
here on the virtual CPU devices of `tests/conftest.py`. Both take the same
tiny-width weights (`compat/jax_params.py`) and the same batch.

- DP, world 2 (`make_mesh(model=None)`): `Trainer.eval_step` and
  `train_step` with the CFM noise (t, z) injected give the global batch's
  losses and grad_norm: against the JAX package's losses with (t, z) injected
  (`tests/test_torch_port_losses.py::jax_losses`, dropout off) jitted on
  inputs sharded over `make_mesh(data=2)`, and `optax.global_norm` of its
  gradient, rtol 2e-5 (`tests/test_train.py:132`); the parameters after two
  train steps (dropout on, the trainer's own generators) equal a world-1
  trainer's on the whole batches within 1e-6.
- TP on a 2 x 2 (`data`, `model`) mesh of 4 ranks: losses against JAX under
  `make_mesh(data=2, model=2)` with `shard_params` (rtol 2e-5,
  `tests/test_train.py:190`) and against the port at world 1; the gradients
  (the model ranks' blocks gathered) against the port at world 1 and JAX; the
  rule table against JAX's `param_spec`, parameter by parameter, through the
  name map.
- `init_distributed`: a no-op without the launcher's variables, idempotent.
"""

import dataclasses
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.matcha import tiny_config as jax_tiny_config
from matcha_tpu.parallel import make_mesh as jax_make_mesh
from matcha_tpu.parallel import param_spec as jax_param_spec
from matcha_tpu.parallel import shard_params as jax_shard_params
from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax
from matcha_tpu_torch.data.dataset import DataConfig
from matcha_tpu_torch.models.matcha import MatchaTTS, tiny_config
from matcha_tpu_torch.parallel import init_distributed, param_spec
from matcha_tpu_torch.train import trainer as trainer_module
from matcha_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_torch_port_losses import jax_losses
from tests.torch_ranks import free_port, rank_env, run_ranks

B, TX, TY = 4, 12, 32
NAMES = ("dur_loss", "prior_loss", "diff_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0, dp_p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(3, 140, size=(B, TX)).astype(np.int32),
            "x_lengths": np.array([12, 9, 5, 11], np.int32),
            "y": rng.standard_normal((B, TY, 8)).astype(np.float32),
            "y_lengths": np.array([32, 27, 20, 30], np.int32)}


@pytest.fixture(scope="module")
def setup():
    """Tiny JAX weights (the prenet projection made non-zero, so its gradient
    path is live), their port state dict, two batches and injected noise."""
    params = jax.tree.map(np.asarray, init_params(JaxMatcha(jax_tiny_config()),
                                                  jax.random.PRNGKey(0), tx=8, ty=16))
    pre = params["encoder"]["ConvReluNorm_0"]["Dense_0"]
    pre["kernel"] = 0.1 * np.random.default_rng(0).standard_normal(
        pre["kernel"].shape).astype(np.float32)
    sd = {k: v.numpy() for k, v in matcha_state_dict_from_jax(params).items()}
    rng = np.random.default_rng(7)
    noise = {"t": rng.uniform(0.05, 0.95, size=B).astype(np.float32),
             "z": rng.standard_normal((B, TY, 8)).astype(np.float32)}
    return params, sd, _batch(1), _batch(2), noise


def _jax_reference(params, batch, noise, mesh):
    """JAX losses and the global norm of their gradient, inputs and (where
    the mesh has a model axis) parameters sharded over `mesh`."""
    cfg = _no_dropout(jax_tiny_config())
    data = NamedSharding(mesh, P("data"))
    args = [jax.device_put(jnp.asarray(batch[k]), data)
            for k in ("x", "x_lengths", "y", "y_lengths")]
    args += [jax.device_put(jnp.asarray(noise[k]), data) for k in ("t", "z")]
    with mesh:
        p = jax_shard_params(mesh, params)
        (_, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_losses(p, cfg, *args), has_aux=True))(p)
    losses = np.array([float(aux[k]) for k in NAMES])
    return losses, float(optax.global_norm(grads)), grads


# ------------------------------------------------------------ DP, world 2
_DP = """
def body(inputs, rank):
    import functools
    import matcha_tpu_torch.train.trainer as T
    from matcha_tpu_torch.data.dataset import DataConfig
    from matcha_tpu_torch.models.matcha import tiny_config
    from matcha_tpu_torch.parallel import make_mesh

    def _no_dropout(cfg):
        import dataclasses as dc
        return dc.replace(cfg, encoder=dc.replace(cfg.encoder, p_dropout=0.0, dp_p_dropout=0.0),
                          decoder=dc.replace(cfg.decoder, dropout=0.0))

    T._tb_importable = lambda: False
    mesh = make_mesh(model=None)
    rows = slice(2 * rank, 2 * rank + 2)
    keys = ("x", "x_lengths", "y", "y_lengths")
    local = lambda tag: {k: inputs[f"{tag}/{k}"][rows] for k in keys}
    sd = {k[3:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("sd/")}
    ckpt = str(inputs["ckpt"]) + f"/r{rank}"
    out = {}

    # injected noise, dropout off: the global batch's losses and grad norm
    tr = T.Trainer(_no_dropout(tiny_config()), T.TrainConfig(ckpt_dir=ckpt, accumulate_steps=1),
                   DataConfig(batch_size=2), device="cpu", mesh=mesh)
    tr.model.load_state_dict(sd)
    tr.model.encoder.prenet.dropout.p = 0.0  # the prenet's fixed 0.1
    tr.model.compute_losses = functools.partial(
        tr.model.compute_losses, t=torch.from_numpy(inputs["t"][rows]),
        z=torch.from_numpy(inputs["z"][rows]))
    out["eval"] = torch.stack([tr.eval_step(local("a"), 0, 0)[k] for k in
                               ("dur_loss", "prior_loss", "diff_loss", "loss")])
    tr.init_optimizer(10)
    out["train"] = tr.dispatch([(local("a"), 0)], 0, eager=True)[0]

    # dropout on, the trainer's generators: two steps
    tr = T.Trainer(tiny_config(), T.TrainConfig(ckpt_dir=ckpt, accumulate_steps=1, seed=3),
                   DataConfig(batch_size=2), device="cpu", mesh=mesh)
    tr.init_optimizer(10)
    out["steps"] = torch.stack([tr.dispatch([(local(tag), i)], 0, eager=True)[0]
                                for i, tag in enumerate("ab")])
    for name, p in tr.model.named_parameters():
        out[f"p/{name}"] = p.detach()

    # the vocoder: a dispatch of 2 GAN steps on this rank's rows of global batches of 4
    from matcha_tpu_torch.data.audio_dataset import SyntheticWavDataset

    voc = _tiny_vocoder(ckpt + "/voc", 2, mesh)
    ds = SyntheticWavDataset(n_items=8, segment_size=2048)
    out["voc_metrics"] = voc.dispatch(list(voc._batches(ds, epoch=0)))
    out["voc_val"] = torch.tensor(voc.validate(ds))
    for i, p in enumerate(voc.opt_g.params + voc.opt_d.params):
        out[f"voc/{i}"] = p.detach()
    return {k: v.numpy() for k, v in out.items()}
"""


def _tiny_vocoder(ckpt, batch, mesh=None):
    """A tiny HiFi-GAN trainer (the vocoder tests' widths) at `batch` a rank,
    K = 2; its source also runs in the ranks."""
    from matcha_tpu_torch.models.hifigan import HiFiGANConfig
    from matcha_tpu_torch.data.audio_dataset import AudioDataConfig
    from matcha_tpu_torch.train.vocoder import Discriminators, VocoderTrainConfig, VocoderTrainer

    disc = Discriminators(mpd_channels=(4, 8), msd_spec=((8, 15, 1, 1, 7), (8, 41, 4, 4, 20),
                                                        (8, 5, 1, 1, 2)))
    tr = VocoderTrainer(HiFiGANConfig(upsample_initial_channel=16),
                        VocoderTrainConfig(ckpt_dir=ckpt, steps_per_dispatch=2),
                        AudioDataConfig(batch_size=batch, segment_size=2048), disc=disc,
                        device="cpu", mesh=mesh)
    tr.init_optimizers(2)
    return tr


_DP += textwrap.dedent(inspect.getsource(_tiny_vocoder))


def _inputs(setup, tmp_path):
    _, sd, a, b, noise = setup
    inputs = {f"sd/{k}": v for k, v in sd.items()}
    inputs.update({f"a/{k}": v for k, v in a.items()})
    inputs.update({f"b/{k}": v for k, v in b.items()})
    inputs.update(noise)
    inputs["ckpt"] = np.array(str(tmp_path / "ck"))
    return inputs


@pytest.fixture(scope="module")
def dp_run(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return run_ranks(_DP, 2, _inputs(setup, tmp), tmp)


def test_dp_eval_and_train_losses_match_jax_global_batch(setup, dp_run):
    params, _, a, _, noise = setup
    want, want_norm, _ = _jax_reference(params, a, noise,
                                        jax_make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    want = np.append(want, want.sum())
    for out in dp_run:  # every rank logs the global values
        np.testing.assert_allclose(out["eval"], want, rtol=2e-5)
        np.testing.assert_allclose(out["train"][:4], want, rtol=2e-5)
        np.testing.assert_allclose(out["train"][4], want_norm, rtol=2e-5)


def test_dp_two_steps_equal_world_one(setup, dp_run, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)
    _, _, a, b, _ = setup
    tr = Trainer(tiny_config(), TrainConfig(ckpt_dir=str(tmp_path), accumulate_steps=1, seed=3),
                 DataConfig(batch_size=4), device="cpu")
    tr.init_optimizer(10)
    steps = torch.stack([tr.dispatch([(batch, i)], 0, eager=True)[0]
                         for i, batch in enumerate((a, b))]).numpy()
    for out in dp_run:
        np.testing.assert_allclose(out["steps"], steps, rtol=2e-5)
        for name, p in tr.model.named_parameters():
            # a key bias shifts all of a query's logits alike: its exact gradient
            # is 0, and Adam's normalised step moves it on round-off, by up to
            # lr a step whatever the world size
            atol = 2 * tr.train_cfg.lr if name.endswith("key_conv.bias") else 1e-6
            np.testing.assert_allclose(out[f"p/{name}"], p.detach().numpy(), rtol=0, atol=atol,
                                       err_msg=name)


def test_dp_vocoder_step_equals_world_one_at_the_global_batch(dp_run, tmp_path, monkeypatch):
    """Two GAN steps at world 2, batch 2 a rank, against world 1 at batch 4 on
    the same segments: metrics rtol 1e-4, parameters within 2.5 lr with under
    1 % past lr / 10 (the one-step bars of tests/test_torch_port_vocoder.py),
    validation mel L1 rtol 1e-5."""
    from matcha_tpu_torch.data.audio_dataset import SyntheticWavDataset

    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)
    voc = _tiny_vocoder(str(tmp_path / "voc"), 4)
    ds = SyntheticWavDataset(n_items=8, segment_size=2048)
    metrics = voc.dispatch(list(voc._batches(ds, epoch=0))).numpy()
    val = voc.validate(ds)
    params = [p.detach().numpy() for p in voc.opt_g.params + voc.opt_d.params]
    lr = voc.train_cfg.lr
    for out in dp_run:
        np.testing.assert_allclose(out["voc_metrics"], metrics, rtol=1e-4)
        np.testing.assert_allclose(out["voc_val"], val, rtol=1e-5)
        gaps = np.concatenate([np.abs(out[f"voc/{i}"] - p).ravel()
                               for i, p in enumerate(params)])
        assert gaps.max() <= 2.5 * lr and (gaps > lr / 10).mean() < 0.01, gaps.max()


# ------------------------------------------------------ TP, a 2 x 2 mesh
_TP = """
def body(inputs, rank):
    import functools
    import matcha_tpu_torch.train.trainer as T
    from matcha_tpu_torch.data.dataset import DataConfig
    from matcha_tpu_torch.models.matcha import tiny_config
    from matcha_tpu_torch.parallel import MODEL_AXIS, make_mesh

    def _no_dropout(cfg):
        import dataclasses as dc
        return dc.replace(cfg, encoder=dc.replace(cfg.encoder, p_dropout=0.0, dp_p_dropout=0.0),
                          decoder=dc.replace(cfg.decoder, dropout=0.0))

    T._tb_importable = lambda: False
    mesh = make_mesh(data=2, model=2)
    d = mesh.index("data")
    rows = slice(2 * d, 2 * d + 2)
    local = {k: inputs[f"a/{k}"][rows] for k in ("x", "x_lengths", "y", "y_lengths")}
    sd = {k[3:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("sd/")}
    tr = T.Trainer(_no_dropout(tiny_config()),
                   T.TrainConfig(ckpt_dir=str(inputs["ckpt"]) + f"/r{rank}", accumulate_steps=1),
                   DataConfig(batch_size=2), device="cpu", mesh=mesh)
    tr._tp.load_state_dict(sd)
    tr.model.encoder.prenet.dropout.p = 0.0  # the prenet's fixed 0.1
    tr.model.compute_losses = functools.partial(
        tr.model.compute_losses, t=torch.from_numpy(inputs["t"][rows]),
        z=torch.from_numpy(inputs["z"][rows]))
    slot = T._Slot("cpu")
    batch = {k: torch.from_numpy(v) for k, v in local.items()}
    losses, grads = tr._losses_and_grads(batch, slot)
    out = {"losses": losses, "norm": tr._norm(grads), "model_index": torch.tensor(mesh.index(MODEL_AXIS))}
    for name, g in zip(tr._tp.names, tr._tp.gather(grads)):
        out[f"g/{name}"] = g
    full = tr._tp.state_dict()
    out["sd_equal"] = torch.tensor(all(torch.equal(full[k], sd[k]) for k in sd))
    return {k: v.detach().numpy() for k, v in out.items()}
"""


@pytest.fixture(scope="module")
def tp_run(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    return run_ranks(_TP, 4, _inputs(setup, tmp), tmp)


@pytest.fixture(scope="module")
def world_one(setup):
    """The port at world 1 on the whole batch: losses, gradients, grad norm."""
    _, sd, a, _, noise = setup
    model = MatchaTTS(_no_dropout(tiny_config()))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.train()
    model.encoder.prenet.dropout.p = 0.0  # the prenet's fixed 0.1
    out = model.compute_losses(*(torch.from_numpy(a[k]) for k in ("x", "x_lengths", "y",
                                                                  "y_lengths")),
                               t=torch.from_numpy(noise["t"]), z=torch.from_numpy(noise["z"]))
    losses = torch.stack([out[k] for k in NAMES])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(losses.sum(), list(model.parameters()), allow_unused=True)
    grads = {n: (torch.zeros_like(p) if g is None else g).numpy()
             for n, g, p in zip(names, grads, model.parameters())}
    return losses.detach().numpy(), grads


def test_tp_losses_match_jax_and_world_one(setup, tp_run, world_one):
    params, _, a, _, noise = setup
    want, want_norm, _ = _jax_reference(params, a, noise,
                                        jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]))
    assert sorted(int(o["model_index"]) for o in tp_run) == [0, 0, 1, 1]
    for out in tp_run:
        np.testing.assert_allclose(out["losses"][:3], want, rtol=2e-5)
        np.testing.assert_allclose(out["losses"][:3], world_one[0], rtol=2e-5)
        np.testing.assert_allclose(out["norm"], want_norm, rtol=2e-5)
        assert out["sd_equal"], "the gathered state dict is not the one loaded"


def test_tp_gradients_match_world_one_and_jax(setup, tp_run, world_one):
    params, _, a, _, noise = setup
    _, _, jax_grads = _jax_reference(params, a, noise,
                                     jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]))
    jax_grads = {k: v.numpy() for k, v in matcha_state_dict_from_jax(
        jax.tree.map(np.asarray, jax_grads)).items()}
    for out in tp_run:
        for name, g in world_one[1].items():
            got = out[f"g/{name}"]
            ref = max(np.abs(g).max(), 1e-12)
            np.testing.assert_allclose(got / ref, g / ref, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(got / ref, jax_grads[name] / ref, atol=1e-4, err_msg=name)


def test_tp_rule_table_matches_jax_param_spec():
    """Each JAX leaf becomes a marker that varies along the axis its spec shards
    (zeros where replicated); after the name and layout map, the port's rule
    must name the dimension along which the port's tensor varies."""
    params = jax.tree.map(np.asarray, init_params(JaxMatcha(jax_tiny_config()),
                                                  jax.random.PRNGKey(0), tx=8, ty=16))

    def marker(path, leaf):
        spec = tuple(jax_param_spec(path, leaf))
        axes = [i for i, s in enumerate(spec) if s == "model"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * leaf.ndim
        shape[axes[0]] = leaf.shape[axes[0]]
        return np.broadcast_to(np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    sd = matcha_state_dict_from_jax(jax.tree_util.tree_map_with_path(marker, params))
    names = {n for n, _ in MatchaTTS(tiny_config()).named_parameters()}
    assert set(sd) == names
    sharded = 0
    for name, t in sd.items():
        varies = [d for d in range(t.dim()) if t.shape[d] > 1
                  and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
        assert param_spec(name) == (varies[0] if varies else None), name
        sharded += bool(varies)
    assert sharded == 10 + 5 * 7  # 10 in the encoder's layer, 7 in each of 5 decoder blocks


def test_tp_refuses_heads_that_do_not_split(tmp_path):
    """`TensorParallel.shard` refuses a model size that does not divide the
    heads (the encoder has 2 at `MatchaConfig()`, so --tp <= 2)."""
    from matcha_tpu_torch.parallel.sharding import TensorParallel

    class FakeMesh:
        def group(self, axis):
            return None

        def index(self, axis):
            return 0

        def size(self, axis):
            return 4

    with pytest.raises(ValueError, match="does not split|heads"):
        TensorParallel(MatchaTTS(tiny_config()), FakeMesh()).shard()


# ------------------------------------------------------- init_distributed
def test_init_distributed_noop_without_environment_and_idempotent(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MATCHA_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert not init_distributed(device="cpu") and not dist.is_initialized()
    env = rank_env(0, 1, free_port())
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.setenv(k, env[k])
    try:
        assert init_distributed(device="cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert init_distributed(device="cpu") is False  # joined once
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()

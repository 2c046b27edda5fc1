"""The port's validation against the JAX trainer's eval step (CPU).

`Trainer.eval_dispatch` (a validation batch: on the card a CUDA graph
replay, here the same function run eagerly) against
`matcha_tpu.train.trainer.make_eval_step`, the jitted
`compute_losses(..., deterministic=True)` the JAX trainer validates with, on
the same tiny weights and batch, the CFM draws (t, z) injected on both sides
(`tests/test_torch_port_losses.py`'s injection; on the JAX side in place of
`jax.random.uniform` and `normal` while the step traces), within 1e-5.
`Trainer.validate` is the n_real-weighted mean of its batches' losses.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tpu.models.matcha import MatchaTTS as JaxMatcha
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.matcha import tiny_config as jax_tiny_config
from matcha_tpu.train.trainer import TrainConfig as JaxTrainConfig
from matcha_tpu.train.trainer import make_eval_step
from matcha_tpu_torch.compat.jax_params import matcha_state_dict_from_jax
from matcha_tpu_torch.data.dataset import DataConfig, SyntheticDataset, batch_iterator
from matcha_tpu_torch.models.matcha import tiny_config
from matcha_tpu_torch.train import trainer as trainer_module
from matcha_tpu_torch.train.trainer import METRICS, TrainConfig, Trainer

B, TX, TY, F = 3, 12, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def trainer(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)
    return Trainer(tiny_config(), TrainConfig(ckpt_dir=str(tmp_path), seed=2),
                   DataConfig(batch_size=B, text_pad_multiple=16, mel_pad_multiple=16),
                   device="cpu")


def test_eval_dispatch_matches_jax_eval_step(trainer, monkeypatch):
    jcfg = jax_tiny_config()
    jcfg = replace(jcfg, decoder=replace(jcfg.decoder, attn_impl="pallas"))
    params = jax.tree.map(np.asarray, init_params(JaxMatcha(jcfg), jax.random.PRNGKey(0),
                                                  tx=8, ty=16))
    # the prenet projection starts at zero; give it weights so its path is live
    pre = params["encoder"]["ConvReluNorm_0"]["Dense_0"]
    pre["kernel"] = 0.1 * np.random.default_rng(0).standard_normal(
        pre["kernel"].shape).astype(np.float32)
    rng = np.random.default_rng(5)
    batch = {"x": rng.integers(3, 140, size=(B, TX)).astype(np.int32),
             "x_lengths": np.array([12, 7, 10], np.int32),
             "y": rng.standard_normal((B, TY, F)).astype(np.float32),
             "y_lengths": np.array([32, 21, 27], np.int32)}
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    z = rng.standard_normal((B, TY, F)).astype(np.float32)

    with monkeypatch.context() as m:  # the draws of `cfm_loss`, while the step traces
        m.setattr(jax.random, "uniform",
                  lambda key, shape, dtype=jnp.float32, **kw: jnp.asarray(t, dtype).reshape(shape))
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=jnp.float32: jnp.asarray(z, dtype).reshape(shape))
        want = make_eval_step(JaxMatcha(jcfg), JaxTrainConfig())(
            params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    want = np.array([float(want[k]) for k in METRICS[:4]])

    trainer.model.load_state_dict(matcha_state_dict_from_jax(params))
    trainer.model.compute_losses = functools.partial(
        trainer.model.compute_losses, t=torch.from_numpy(t), z=torch.from_numpy(z))
    got = trainer.eval_dispatch(batch, 0, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert trainer.model.training is False and trainer.eval_replays == 0  # eager on the CPU
    np.testing.assert_array_equal(
        np.stack([v.numpy() for v in trainer.eval_step(batch, 0, 0).values()]), got)


def test_validate_is_the_weighted_mean_of_its_batches(trainer):
    """7 items at batch 3: two full batches and one of 1 item wrap-padded to
    3; each batch's CFM noise seeded by (seed + 2, epoch, index)."""
    ds = SyntheticDataset(n_items=7, n_mels=F, seed=4, min_frames=30, max_frames=60)
    epoch = 3
    agg = trainer.validate(ds, epoch)
    batches = list(batch_iterator(ds, trainer.data_cfg, shuffle=False, drop_last=False))
    weights = np.array([b.pop("n_real") for b in batches], np.float64)
    assert weights.tolist() == [3, 3, 1]
    losses = np.stack([np.stack([v.numpy() for v in trainer.eval_step(b, epoch, i).values()])
                       for i, b in enumerate(batches)]).astype(np.float64)
    want = (losses * weights[:, None]).sum(0) / weights.sum()
    assert list(agg) == list(METRICS[:4])
    np.testing.assert_allclose([agg[k] for k in METRICS[:4]], want, rtol=1e-12)
    # another epoch draws other noise
    assert trainer.validate(ds, epoch + 1)["diff_loss"] != agg["diff_loss"]

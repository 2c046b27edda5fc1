"""Data-parallel `Trainer.fit` follows world 1 (CPU, gloo ranks).

One epoch of `fit` at 2 ranks, batch 2 a rank, against world 1 at batch 4
on the same items, with dropout on and the trainer's own generators: each
rank loads its block of every global batch and draws its rows of the global
batch's noise, crops and dropout, so every logged value (training losses and
grad_norm each step, the validation losses, a wrap-padded validation batch
included) is within rtol 2e-5 (`tests/test_torch_port_parallel.py`'s bar)
and the parameters are within 1e-6, the key biases within 2 lr as in
`test_dp_two_steps_equal_world_one`.
"""

import inspect
import json
import textwrap

import numpy as np
import pytest
import torch

from matcha_tpu_torch.train import trainer as trainer_module
from tests.torch_ranks import run_ranks

# 16 training items: 4 micro-steps of the global batch of 4, 2 updates; 6
# validation items: a full batch and one of 2 items wrap-padded to 4
TRAIN_ITEMS, VAL_ITEMS, GLOBAL_BATCH = 16, 6, 4
# values that are wall-clock readings, not results
CLOCKS = ("time", "val/epoch_seconds")

_FIT = """
def body(inputs, rank):
    import matcha_tpu_torch.train.trainer as T
    from matcha_tpu_torch.parallel import make_mesh

    T._tb_importable = lambda: False
    world = int(inputs["world"])
    tr = _trainer(str(inputs["ckpt"]), int(inputs["batch"]) // world, make_mesh(model=None))
    tr.fit(*_datasets(), max_epochs=1, resume=False)
    return {name: p.detach().numpy() for name, p in tr.model.named_parameters()}
"""


def _trainer(ckpt, batch, mesh=None):
    """A tiny trainer at `batch` a rank; its source also runs in the ranks."""
    import matcha_tpu_torch.train.trainer as T
    from matcha_tpu_torch.data.dataset import DataConfig
    from matcha_tpu_torch.models.matcha import tiny_config

    return T.Trainer(tiny_config(), T.TrainConfig(ckpt_dir=ckpt, log_every=1, seed=5),
                     DataConfig(batch_size=batch, text_pad_multiple=16, mel_pad_multiple=16),
                     device="cpu", mesh=mesh)


def _datasets():
    from matcha_tpu_torch.data.dataset import SyntheticDataset

    n_feats = 8  # tiny_config's
    return (SyntheticDataset(n_items=16, n_mels=n_feats, seed=0, min_frames=40, max_frames=90),
            SyntheticDataset(n_items=6, n_mels=n_feats, seed=1, min_frames=40, max_frames=90))


_FIT += textwrap.dedent(inspect.getsource(_trainer)) + textwrap.dedent(
    inspect.getsource(_datasets))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(path):
    """The logged rows of a metrics file, wall-clock readings dropped."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in CLOCKS} for r in rows]


def test_dp_fit_two_ranks_equals_world_one(tmp_path, monkeypatch):
    train_ds, val_ds = _datasets()
    assert (len(train_ds), len(val_ds)) == (TRAIN_ITEMS, VAL_ITEMS)
    ckpt = tmp_path / "dp"
    outs = run_ranks(_FIT, 2, {"ckpt": np.array(str(ckpt)), "world": np.array(2),
                               "batch": np.array(GLOBAL_BATCH)}, tmp_path)

    monkeypatch.setattr(trainer_module, "_tb_importable", lambda: False)
    one = _trainer(str(tmp_path / "one"), GLOBAL_BATCH)
    assert one.fit(train_ds, val_ds, max_epochs=1, resume=False) == TRAIN_ITEMS // GLOBAL_BATCH
    want = _rows(tmp_path / "one" / "logs" / "metrics.jsonl")
    assert [r["step"] for r in want if "train/loss" in r] == [0, 1, 2, 3]
    assert sum("val/loss" in r for r in want) == 1

    for log in ("metrics.jsonl", "metrics_rank1.jsonl"):  # every rank logs the global values
        got = _rows(ckpt / "logs" / log)
        assert [sorted(r) for r in got] == [sorted(r) for r in want], log
        for g, w in zip(got, want):
            for key, value in w.items():
                np.testing.assert_allclose(g[key], value, rtol=2e-5, err_msg=f"{log} {key}")
    for out in outs:
        for name, p in one.model.named_parameters():
            # a key bias shifts all of a query's logits alike: its exact gradient
            # is 0, and Adam's normalised step moves it on round-off
            atol = 2 * one.train_cfg.lr if name.endswith("key_conv.bias") else 1e-6
            np.testing.assert_allclose(out[name], p.detach().numpy(), rtol=0, atol=atol,
                                       err_msg=name)

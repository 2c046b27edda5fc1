"""Load the reference's released PyTorch checkpoints into the port.

The port's counterpart of `matcha_tpu/compat/torch_import.py`:

  * `load_matcha_torch_checkpoint`: a Lightning `.ckpt` of the reference
    MatchaTTS (`matcha_final.ckpt`) -> the port's `MatchaTTS` state dict;
  * `load_hifigan_torch_checkpoint`: the released `generator_v1`
    (weight-normed) -> the port's serving `Generator`, weight norm folded
    (`remove_weight_norm()` semantics), which runs K2 on the card.

What differs from the JAX converters: the port keeps the reference's layout
and key names, so there is no transpose and no renaming. A loader takes the
state dict as it is, keeps exactly the keys the port's module has (any other
key is ignored, as the JAX converters, which read by name, ignore it), and
raises `ValueError` naming the key when one is missing or has another shape
(the JAX package's `_validate_tree`).

Both files are pickles and are read with `weights_only=False`, as the JAX
package reads them (a Lightning checkpoint holds more than tensors): load
only files you trust.
"""

from typing import Dict, Optional

import torch
import torch.nn as nn

from matcha_tpu_torch.models.hifigan import Generator, HiFiGANConfig, fold_weight_norm
from matcha_tpu_torch.models.matcha import MatchaConfig, MatchaTTS


def _load(path, entry: str) -> Dict[str, torch.Tensor]:
    """The tensors of `ckpt[entry]`, or of the checkpoint itself without that entry."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get(entry, ckpt)
    return {k: v.detach() for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _select(sd: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]):
    """The keys of `like` from `sd`, cast to their dtype; raises on a missing key
    or another shape."""
    out = {}
    for key, want in like.items():
        if key not in sd:
            raise ValueError(f"checkpoint has no '{key}'")
        got = sd[key]
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at '{key}': got {tuple(got.shape)}, "
                             f"want {tuple(want.shape)}")
        out[key] = got.to(want.dtype).contiguous()
    return out


def _meta_state(build) -> Dict[str, torch.Tensor]:
    """The state dict (names, shapes, dtypes) of a module built on the meta device."""
    with torch.device("meta"):
        return build().state_dict()


def load_matcha_torch_checkpoint(path, model: Optional[nn.Module] = None
                                 ) -> Dict[str, torch.Tensor]:
    """A reference Lightning checkpoint (`ckpt["state_dict"]`, else the dict
    itself) -> the state dict of `model` (default: `MatchaTTS(MatchaConfig())`),
    loaded into `model` when one is given. On the CPU."""
    like = (model.state_dict() if model is not None
            else _meta_state(lambda: MatchaTTS(MatchaConfig())))
    sd = _select(_load(path, "state_dict"), like)
    if model is not None:
        model.load_state_dict(sd)
    return sd


def load_hifigan_torch_checkpoint(path, cfg: HiFiGANConfig = HiFiGANConfig()) -> Generator:
    """The released HiFi-GAN generator (`ckpt["generator"]`, else the dict
    itself; `weight_g`/`weight_v` folded over every axis but 0) -> the serving
    `Generator(cfg)`, in eval mode on the CPU."""
    sd = _select(fold_weight_norm(_load(path, "generator")), _meta_state(lambda: Generator(cfg)))
    gen = Generator(cfg)
    gen.load_state_dict(sd)
    return gen.eval()

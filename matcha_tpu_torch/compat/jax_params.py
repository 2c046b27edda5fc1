"""JAX (flax) parameter trees -> the port's state dicts.

The inverse of the JAX package's `convert_matcha_state_dict` and
`convert_hifigan_state_dict`, written without importing either: the trees come
in as nested dicts of numpy arrays (or anything `numpy.asarray` reads) and go
out as `{reference torch name: float32 tensor}` dicts that the port's
`MatchaTTS` and `Generator` load directly.

Layout transforms (flax -> torch):
    Dense kernel (in, out)                 -> Linear weight (out, in)
    Dense kernel standing for a 1x1 conv   -> Conv1d weight (out, in, 1)
    Conv kernel (k, in, out)               -> Conv1d weight (out, in, k)
    Conv kernel (k, 1, in, out)            -> Conv2d weight (out, in, k, 1)
    ConvTranspose kernel (k, out, in)      -> ConvTranspose1d weight (in, out, k)
    WeightNorm scale '<path>/kernel/scale' -> `weight_g` (C, 1, 1), with the
        kernel at <path> as `weight_v`; C is flax's feature axis, the
        kernel's last: a conv's output channels, a transposed conv's input
        channels, torch's dim 0 either way
"""

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _linear(p):
    return _t(np.asarray(p["kernel"]).T)


def _conv1x1(p):
    return _t(np.asarray(p["kernel"]).T[:, :, None])


def _conv(p):
    return _t(np.asarray(p["kernel"]).transpose(2, 1, 0))


def _count(tree, prefix: str) -> int:
    return sum(1 for k in tree if re.fullmatch(rf"{prefix}_\d+", k))


def _put(sd, name, weight, p=None):
    """weight (already a tensor) + the bias/scale of flax node `p`."""
    sd[f"{name}.weight"] = weight
    if p is not None and "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _encoder(enc) -> Dict[str, torch.Tensor]:
    sd = {"embedding.weight": _t(enc["Embed_0"]["embedding"])}
    pre = enc["ConvReluNorm_0"]
    for i in range(_count(pre, "Conv")):
        _put(sd, f"prenet.convolutions.{i}", _conv(pre[f"Conv_{i}"]), pre[f"Conv_{i}"])
        _norm(sd, f"prenet.normalizations.{i}", pre[f"LayerNorm_{i}"])
    _put(sd, "prenet.projection", _conv1x1(pre["Dense_0"]), pre["Dense_0"])
    tr = enc["TransformerEncoder_0"]
    for i in range(_count(tr, "RoPEMultiHeadAttention")):
        a = tr[f"RoPEMultiHeadAttention_{i}"]
        for src, dst in (("query", "query_conv"), ("key", "key_conv"),
                         ("value", "value_conv"), ("out", "output_conv")):
            _put(sd, f"encoder.attention_layers.{i}.{dst}", _conv1x1(a[src]), a[src])
        _norm(sd, f"encoder.norm_layers_1.{i}", tr[f"LayerNorm_{2 * i}"])
        f = tr[f"ConvFFN_{i}"]
        _put(sd, f"encoder.ffn_layers.{i}.conv_net.0", _conv(f["Conv_0"]), f["Conv_0"])
        _put(sd, f"encoder.ffn_layers.{i}.conv_net.3", _conv(f["Conv_1"]), f["Conv_1"])
        _norm(sd, f"encoder.norm_layers_2.{i}", tr[f"LayerNorm_{2 * i + 1}"])
    _put(sd, "mean_projection", _conv1x1(enc["mean_projection"]), enc["mean_projection"])
    dp = enc["DurationPredictor_0"]
    for n in (1, 2):
        _put(sd, f"duration_predictor.conv_layer_{n}", _conv(dp[f"Conv_{n - 1}"]),
             dp[f"Conv_{n - 1}"])
        _norm(sd, f"duration_predictor.norm_layer_{n}", dp[f"LayerNorm_{n - 1}"])
    _put(sd, "duration_predictor.output_projection", _conv1x1(dp["Dense_0"]), dp["Dense_0"])
    return sd


def _resnet(sd, name, p):
    for b in (0, 1):
        blk = p[f"Block1D_{b}"]
        _put(sd, f"{name}.block{b + 1}.block.0", _conv(blk["Conv_0"]), blk["Conv_0"])
        _norm(sd, f"{name}.block{b + 1}.block.1", blk["GroupNorm_0"])
    _put(sd, f"{name}.mlp.1", _linear(p["Dense_0"]), p["Dense_0"])
    _put(sd, f"{name}.res_conv", _conv(p["Conv_0"]), p["Conv_0"])


def _transformer(sd, name, p):
    _norm(sd, f"{name}.norm1", p["LayerNorm_0"])
    a = p["DiffusersAttention_0"]
    for proj in ("to_q", "to_k", "to_v"):
        sd[f"{name}.attn1.{proj}.weight"] = _linear(a[proj])
    _put(sd, f"{name}.attn1.to_out.0", _linear(a["to_out"]), a["to_out"])
    _norm(sd, f"{name}.norm3", p["LayerNorm_1"])
    ff = p["FeedForward_0"]
    if "SnakeBeta_0" in ff:  # the activation's own scope, then the output Dense
        act, out = ff["SnakeBeta_0"], ff["Dense_0"]
        _put(sd, f"{name}.ff.net.0.proj", _linear(act["Dense_0"]), act["Dense_0"])
        sd[f"{name}.ff.net.0.alpha"] = _t(act["alpha"])
        sd[f"{name}.ff.net.0.beta"] = _t(act["beta"])
    else:  # gelu, gelu-approximate, geglu (the projection to 2 x hidden: value, gate)
        act, out = ff["Dense_0"], ff["Dense_1"]
        _put(sd, f"{name}.ff.net.0.proj", _linear(act), act)
    _put(sd, f"{name}.ff.net.2", _linear(out), out)


def _decoder(dec) -> Dict[str, torch.Tensor]:
    sd = {}
    te = dec["TimestepEmbedding_0"]
    _put(sd, "time_mlp.linear_1", _linear(te["Dense_0"]), te["Dense_0"])
    _put(sd, "time_mlp.linear_2", _linear(te["Dense_1"]), te["Dense_1"])
    levels = _count(dec, "Downsample1D") + 1
    n_res = _count(dec, "ResnetBlock1D")
    n_mid = n_res - 2 * levels
    per = _count(dec, "BasicTransformerBlock") // n_res  # transformer blocks per stage
    stages = ([f"Downsampling_Blocks.{i}" for i in range(levels)]
              + [f"Mid_Blocks.{i}" for i in range(n_mid)]
              + [f"Upsampling_Blocks.{i}" for i in range(levels)])
    for n, stage in enumerate(stages):
        _resnet(sd, f"{stage}.0", dec[f"ResnetBlock1D_{n}"])
        for j in range(per):
            _transformer(sd, f"{stage}.1.{j}", dec[f"BasicTransformerBlock_{n * per + j}"])
    for i in range(levels - 1):
        c = dec[f"Downsample1D_{i}"]["Conv_0"]
        _put(sd, f"Downsampling_Blocks.{i}.2.conv", _conv(c), c)
        u = dec[f"Upsample1D_{i}"]["ConvTranspose_0"]
        _put(sd, f"Upsampling_Blocks.{i}.2.conv", _conv(u), u)
    last = levels - 1
    _put(sd, f"Downsampling_Blocks.{last}.2", _conv(dec["Conv_0"]), dec["Conv_0"])
    _put(sd, f"Upsampling_Blocks.{last}.2", _conv(dec["Conv_1"]), dec["Conv_1"])
    _put(sd, "final_conv", _conv(dec["Conv_2"]), dec["Conv_2"])
    _norm(sd, "final_norm", dec["GroupNorm_0"])
    _put(sd, "final_proj", _conv(dec["Conv_3"]), dec["Conv_3"])
    return sd


def matcha_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX MatchaTTS params {"encoder": ..., "decoder": ...} -> port state dict."""
    sd = {f"encoder.{k}": v for k, v in _encoder(params["encoder"]).items()}
    sd.update({f"decoder.estimator.{k}": v for k, v in _decoder(params["decoder"]).items()})
    return sd


def _split_weight_norm(tree) -> Tuple[dict, Dict[tuple, np.ndarray]]:
    """(the tree without its flax `WeightNorm_*` scopes, {path of the wrapped
    conv: its kernel scale}); a scope's entry '<path>/kernel/scale' names a
    conv relative to the scope's parent."""
    scales = {}

    def walk(node, prefix):
        out = {}
        for key, val in node.items():
            if key.startswith("WeightNorm_"):
                for name, scale in val.items():
                    parts = tuple(name.split("/"))
                    if parts[-2:] != ("kernel", "scale"):
                        raise ValueError(f"unexpected WeightNorm entry: {name}")
                    scales[prefix + parts[:-2]] = scale
            elif isinstance(val, Mapping):
                out[key] = walk(val, prefix + (key,))
            else:
                out[key] = val
        return out

    return walk(tree, ()), scales


def hifigan_state_dict_from_jax(params, resblock: str = "1") -> Dict[str, torch.Tensor]:
    """JAX Generator params -> port `Generator` state dict.

    A `Generator(weight_norm=False)` tree gives `<name>.weight`; a
    `Generator(weight_norm=True)` tree gives `<name>.weight_g` and
    `<name>.weight_v`, the training form's keys (the serving form folds them).
    `resblock` is the config's ResBlock type: "1" pairs each dilated conv
    (WNConv_{2m} -> convs1.m) with a second conv (WNConv_{2m+1} -> convs2.m);
    "2" has one conv per dilation (WNConv_m -> convs.m).
    """
    params, scales = _split_weight_norm(params)
    sd = {}

    def put(dst, *path):
        node = params
        for key in path:
            node = node[key]
        scale = scales.get(path)
        if scale is None:
            _put(sd, dst, _conv(node), node)
            return
        v = _conv(node)
        sd[f"{dst}.weight_v"] = v
        sd[f"{dst}.weight_g"] = _t(scale).reshape((v.shape[0],) + (1,) * (v.ndim - 1))
        sd[f"{dst}.bias"] = _t(node["bias"])

    put("conv_pre", "conv_pre")
    n_k = sum(1 for k in params if re.fullmatch(r"res_0_\d+", k))
    for i in range(_count(params, "up")):
        put(f"ups.{i}", f"up_{i}")
        for j in range(n_k):
            blk = params[f"res_{i}_{j}"]
            name = f"resblocks.{i * n_k + j}"
            if resblock == "1":
                pairs = [(2 * m + s, f"{name}.convs{s + 1}.{m}")
                         for m in range(_count(blk, "WNConv") // 2) for s in (0, 1)]
            else:
                pairs = [(m, f"{name}.convs.{m}") for m in range(_count(blk, "WNConv"))]
            for src, dst in pairs:
                put(dst, f"res_{i}_{j}", f"WNConv_{src}", "Conv_0")
    put("conv_post", "conv_post")
    return sd


def discriminators_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX `train.vocoder.Discriminators` params {"mpd": ..., "msd": ...} -> the
    port's `Discriminators` state dict: period discriminator p{p} (by rising
    period) -> mpd.discriminators.{i}, scale s{i} -> msd.discriminators.{i};
    Conv_{j} -> convs.{j}, the last Conv -> conv_post."""
    sd = {}
    for group, layout in (("mpd", (3, 2, 0, 1)), ("msd", (2, 1, 0))):
        tree = params[group]
        for i, key in enumerate(sorted(tree, key=lambda k: int(k[1:]))):
            d = tree[key]
            n = _count(d, "Conv")
            for j in range(n):
                c = d[f"Conv_{j}"]
                dst = f"{group}.discriminators.{i}." + (f"convs.{j}" if j < n - 1 else "conv_post")
                _put(sd, dst, _t(np.asarray(c["kernel"]).transpose(layout)), c)
    return sd

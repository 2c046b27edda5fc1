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
    ConvTranspose kernel (k, out, in)      -> ConvTranspose1d weight (in, out, k)
"""

import re
from typing import Dict

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
    _put(sd, f"{name}.ff.net.0.proj", _linear(ff["Dense_0"]), ff["Dense_0"])
    _put(sd, f"{name}.ff.net.2", _linear(ff["Dense_1"]), ff["Dense_1"])


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


def hifigan_state_dict_from_jax(params, resblock: str = "1") -> Dict[str, torch.Tensor]:
    """JAX Generator(weight_norm=False) params -> port `Generator` state dict.

    `resblock` is the config's ResBlock type: "1" pairs each dilated conv
    (WNConv_{2m} -> convs1.m) with a second conv (WNConv_{2m+1} -> convs2.m);
    "2" has one conv per dilation (WNConv_m -> convs.m).
    """
    sd = {}
    _put(sd, "conv_pre", _conv(params["conv_pre"]), params["conv_pre"])
    n_k = sum(1 for k in params if re.fullmatch(r"res_0_\d+", k))
    for i in range(_count(params, "up")):
        _put(sd, f"ups.{i}", _conv(params[f"up_{i}"]), params[f"up_{i}"])
        for j in range(n_k):
            blk = params[f"res_{i}_{j}"]
            name = f"resblocks.{i * n_k + j}"
            if resblock == "1":
                pairs = [(2 * m + s, f"{name}.convs{s + 1}.{m}")
                         for m in range(_count(blk, "WNConv") // 2) for s in (0, 1)]
            else:
                pairs = [(m, f"{name}.convs.{m}") for m in range(_count(blk, "WNConv"))]
            for src, dst in pairs:
                c = blk[f"WNConv_{src}"]["Conv_0"]
                _put(sd, dst, _conv(c), c)
    _put(sd, "conv_post", _conv(params["conv_post"]), params["conv_post"])
    return sd

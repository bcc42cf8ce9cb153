"""Carry the JAX package's weights across to the port.

Turns the JAX package's flax variables, as numpy arrays (``np.asarray`` of
each leaf), into the port's torch ``state_dict``s:

- :func:`facetts_state_dict`: FaceTTS ``{"params", "batch_stats"}`` ->
  ``FaceTTS.state_dict()`` (encoder, decoder U-Net, SyncNet), and the same
  per module (:func:`text_encoder_state_dict`, :func:`unet_state_dict`,
  :func:`syncnet_state_dict`);
- :func:`hifigan_state_dict`: HiFi-GAN ``params`` ->
  ``HiFiGANGenerator.state_dict()``;
- :func:`discriminator_state_dict`: ``SpectrogramDiscriminator`` ``params``
  (parity family, weight norm) -> the port's discriminator state_dict;
- :func:`utmos_state_dict`: the SSL MOS model ``UTMOSStrong``'s ``params``
  -> the port's ``UTMOSStrong`` state_dict.

Layouts: conv kernels (kh, kw, I, O) / (k, I, O) become (O, I, kh, kw) /
(O, I, k); Dense layers that stand in for 1x1 convs become (O, I, 1[, 1]);
transposed-conv kernels (k.., I, O) become torch's (I, O, k..); flax
``WeightNorm``'s per-channel ``scale`` becomes ``weight_g`` (O, 1, 1, 1) and
the kernel it normalises ``weight_v``; flax
BatchNorm ``mean`` / ``var`` become ``running_mean`` / ``running_var``.
Variables initialised through ``FaceTTS.compute_loss`` hold the whole model
that the loss runs, the SyncNet audio stream and its ``batch_stats``
included.  A SyncNet stream that the flax variables lack (an inference-only
face-mode init never runs the audio stream; a speech-mode loss never runs
the image stream) is left out; load such a state_dict with ``strict=False``.
Without ``batch_stats`` the BatchNorm running statistics are left out: that
is how a JAX gradient tree, ``{"params": grads}``, comes under the port's
parameter names.  This is the exact inverse of the JAX package's torch
importers (``train/checkpoint.py``), which the round-trip test holds it to.
"""

from typing import Any, Dict

import numpy as np
import torch


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _conv2d(k) -> np.ndarray:
    return _a(k).transpose(3, 2, 0, 1)


def _conv1d(k) -> np.ndarray:
    return _a(k).transpose(2, 1, 0)


def _dense_as_conv(k, ndim: int) -> np.ndarray:
    k = _a(k).T
    return k.reshape(*k.shape, *([1] * ndim))


def _convt2d(k) -> np.ndarray:
    return _a(k).transpose(2, 3, 0, 1)


def _convt1d(k) -> np.ndarray:
    return _a(k).transpose(1, 2, 0)


class _SD(dict):
    def put(self, name: str, value) -> None:
        self[name] = torch.from_numpy(np.array(value, dtype=np.float32))


def _text_encoder(sd: _SD, p: Dict[str, Any], pre: str) -> None:
    sd.put(pre + "emb.weight", p["emb"]["embedding"])
    pn = p["prenet"]
    i = 0
    while f"conv_{i}" in pn:
        sd.put(f"{pre}prenet.conv_layers.{i}.weight", _conv1d(pn[f"conv_{i}"]["kernel"]))
        sd.put(f"{pre}prenet.conv_layers.{i}.bias", pn[f"conv_{i}"]["bias"])
        sd.put(f"{pre}prenet.norm_layers.{i}.gamma", pn[f"norm_{i}"]["gamma"])
        sd.put(f"{pre}prenet.norm_layers.{i}.beta", pn[f"norm_{i}"]["beta"])
        i += 1
    sd.put(pre + "prenet.proj.weight", _dense_as_conv(pn["proj"]["kernel"], 1))
    sd.put(pre + "prenet.proj.bias", pn["proj"]["bias"])
    enc = p["encoder"]
    i = 0
    while f"attn_{i}" in enc:
        a, e = enc[f"attn_{i}"], f"{pre}encoder."
        for n in ("conv_q", "conv_k", "conv_v", "conv_o"):
            sd.put(f"{e}attn_layers.{i}.{n}.weight", _dense_as_conv(a[n]["kernel"], 1))
            sd.put(f"{e}attn_layers.{i}.{n}.bias", a[n]["bias"])
        sd.put(f"{e}attn_layers.{i}.emb_rel_k", _a(a["emb_rel_k"])[None])
        sd.put(f"{e}attn_layers.{i}.emb_rel_v", _a(a["emb_rel_v"])[None])
        for n in ("conv_1", "conv_2"):
            sd.put(f"{e}ffn_layers.{i}.{n}.weight", _conv1d(enc[f"ffn_{i}"][n]["kernel"]))
            sd.put(f"{e}ffn_layers.{i}.{n}.bias", enc[f"ffn_{i}"][n]["bias"])
        for src, dst in ((f"norm1_{i}", f"norm_layers_1.{i}"), (f"norm2_{i}", f"norm_layers_2.{i}")):
            sd.put(f"{e}{dst}.gamma", enc[src]["gamma"])
            sd.put(f"{e}{dst}.beta", enc[src]["beta"])
        i += 1
    sd.put(pre + "proj_m.weight", _dense_as_conv(p["proj_m"]["kernel"], 1))
    sd.put(pre + "proj_m.bias", p["proj_m"]["bias"])
    w = p["proj_w"]
    for n in ("conv_1", "conv_2"):
        sd.put(f"{pre}proj_w.{n}.weight", _conv1d(w[n]["kernel"]))
        sd.put(f"{pre}proj_w.{n}.bias", w[n]["bias"])
    for n in ("norm_1", "norm_2"):
        sd.put(f"{pre}proj_w.{n}.gamma", w[n]["gamma"])
        sd.put(f"{pre}proj_w.{n}.beta", w[n]["beta"])
    sd.put(pre + "proj_w.proj.weight", _dense_as_conv(w["proj"]["kernel"], 1))
    sd.put(pre + "proj_w.proj.bias", w["proj"]["bias"])


def _linear(sd: _SD, name: str, p) -> None:
    sd.put(name + ".weight", _a(p["kernel"]).T)
    sd.put(name + ".bias", p["bias"])


def _block(sd: _SD, pre: str, p) -> None:
    sd.put(pre + ".block.0.weight", _conv2d(p["conv"]["kernel"]))
    sd.put(pre + ".block.0.bias", p["conv"]["bias"])
    sd.put(pre + ".block.1.weight", p["norm"]["scale"])
    sd.put(pre + ".block.1.bias", p["norm"]["bias"])


def _resnet(sd: _SD, pre: str, p) -> None:
    _linear(sd, pre + ".mlp.1", p["mlp"])
    _block(sd, pre + ".block1", p["block1"])
    _block(sd, pre + ".block2", p["block2"])
    if "res_conv" in p:
        sd.put(pre + ".res_conv.weight", _dense_as_conv(p["res_conv"]["kernel"], 2))
        sd.put(pre + ".res_conv.bias", p["res_conv"]["bias"])


def _attn(sd: _SD, pre: str, p) -> None:
    sd.put(pre + ".fn.g", p["g"])
    sd.put(pre + ".fn.fn.to_qkv.weight", _dense_as_conv(p["fn"]["to_qkv"]["kernel"], 2))
    sd.put(pre + ".fn.fn.to_out.weight", _dense_as_conv(p["fn"]["to_out"]["kernel"], 2))
    sd.put(pre + ".fn.fn.to_out.bias", p["fn"]["to_out"]["bias"])


def _unet(sd: _SD, p: Dict[str, Any], pre: str) -> None:
    if "spk_mlp_1" in p:
        _linear(sd, pre + "spk_mlp.0", p["spk_mlp_1"])
        _linear(sd, pre + "spk_mlp.2", p["spk_mlp_2"])
    _linear(sd, pre + "mlp.0", p["mlp_1"])
    _linear(sd, pre + "mlp.2", p["mlp_2"])
    i = 0
    while f"down_{i}_res1" in p:
        _resnet(sd, f"{pre}downs.{i}.0", p[f"down_{i}_res1"])
        _resnet(sd, f"{pre}downs.{i}.1", p[f"down_{i}_res2"])
        _attn(sd, f"{pre}downs.{i}.2", p[f"down_{i}_attn"])
        if f"down_{i}_ds" in p:
            sd.put(f"{pre}downs.{i}.3.conv.weight", _conv2d(p[f"down_{i}_ds"]["conv"]["kernel"]))
            sd.put(f"{pre}downs.{i}.3.conv.bias", p[f"down_{i}_ds"]["conv"]["bias"])
        i += 1
    _resnet(sd, pre + "mid_block1", p["mid_res1"])
    _attn(sd, pre + "mid_attn", p["mid_attn"])
    _resnet(sd, pre + "mid_block2", p["mid_res2"])
    j = 0
    while f"up_{j}_res1" in p:
        _resnet(sd, f"{pre}ups.{j}.0", p[f"up_{j}_res1"])
        _resnet(sd, f"{pre}ups.{j}.1", p[f"up_{j}_res2"])
        _attn(sd, f"{pre}ups.{j}.2", p[f"up_{j}_attn"])
        sd.put(f"{pre}ups.{j}.3.conv.weight", _convt2d(p[f"up_{j}_us"]["kernel"]))
        sd.put(f"{pre}ups.{j}.3.conv.bias", p[f"up_{j}_us"]["bias"])
        j += 1
    _block(sd, pre + "final_block", p["final_block"])
    sd.put(pre + "final_conv.weight", _dense_as_conv(p["final_conv"]["kernel"], 2))
    sd.put(pre + "final_conv.bias", p["final_conv"]["bias"])


# Sequential indices of the reference SyncNet (syncnet_hifigan.py:21-84)
_SYNC_IDX = {
    "aud": ([0, 4, 8, 12, 15, 19], [1, 5, 9, 13, 16, 20]),
    "img": ([0, 4, 8, 11, 14, 18], [1, 5, 9, 12, 15, 19]),
}


def _bn(sd: _SD, name: str, p, s) -> None:
    sd.put(name + ".weight", p["scale"])
    sd.put(name + ".bias", p["bias"])
    if s is None:
        return
    sd.put(name + ".running_mean", s["mean"])
    sd.put(name + ".running_var", s["var"])
    sd[name + ".num_batches_tracked"] = torch.tensor(0)


def _syncnet(sd: _SD, p, s, pre: str) -> None:
    for stream, (convs, bns) in _SYNC_IDX.items():
        if f"{stream}_c1" not in p:
            continue  # flax builds the audio stream only once it has run
        for n, (ci, bi) in enumerate(zip(convs, bns), start=1):
            c = p[f"{stream}_c{n}"]
            sd.put(f"{pre}netcnn{stream}.{ci}.weight", _conv2d(c["conv"]["kernel"]))
            sd.put(f"{pre}netcnn{stream}.{ci}.bias", c["conv"]["bias"])
            _bn(sd, f"{pre}netcnn{stream}.{bi}", c["bn"],
                None if s is None else s[f"{stream}_c{n}"]["bn"])
        h = p[f"{stream}_head"]
        sd.put(f"{pre}netfc{stream}.0.weight", _dense_as_conv(h["fc1"]["kernel"], 1))
        sd.put(f"{pre}netfc{stream}.0.bias", h["fc1"]["bias"])
        _bn(sd, f"{pre}netfc{stream}.1", h["bn"],
            None if s is None else s[f"{stream}_head"]["bn"])
        sd.put(f"{pre}netfc{stream}.3.weight", _dense_as_conv(h["fc2"]["kernel"], 1))
        sd.put(f"{pre}netfc{stream}.3.bias", h["fc2"]["bias"])


def text_encoder_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TextEncoder`` params -> the port's ``TextEncoder`` state_dict."""
    sd = _SD()
    _text_encoder(sd, params, "")
    return dict(sd)


def unet_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``GradLogPEstimator2d`` params -> the port's state_dict."""
    sd = _SD()
    _unet(sd, params, "")
    return dict(sd)


def syncnet_state_dict(params: Dict[str, Any], batch_stats: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """JAX ``SyncNet`` params + batch_stats -> the port's state_dict."""
    sd = _SD()
    _syncnet(sd, params, batch_stats, "")
    return dict(sd)


def facetts_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FaceTTS variables ``{"params", "batch_stats"}`` -> the port's
    ``FaceTTS`` state_dict (``{"params": grads}`` -> gradients by name)."""
    p = variables["params"]
    sd = _SD()
    _text_encoder(sd, p["encoder"], "encoder.")
    _unet(sd, p["decoder"]["estimator"], "decoder.estimator.")
    stats = variables.get("batch_stats")
    _syncnet(sd, p["syncnet"], None if stats is None else stats["syncnet"], "syncnet.")
    return dict(sd)


def hifigan_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX HiFiGANGenerator ``params`` -> the port's ``HiFiGANGenerator``
    state_dict (plain weights; weight norm is already folded)."""
    sd = _SD()
    for n in ("conv_pre", "conv_post"):
        sd.put(n + ".weight", _conv1d(params[n]["kernel"]))
        sd.put(n + ".bias", params[n]["bias"])
    n_ups = 0
    while f"up_{n_ups}_kernel" in params:
        n_ups += 1
    n_res = sum(1 for k in params if k.startswith("res_0_"))
    for i in range(n_ups):
        sd.put(f"ups.{i}.weight", _convt1d(params[f"up_{i}_kernel"]))
        sd.put(f"ups.{i}.bias", params[f"up_{i}_bias"])
        for j in range(n_res):
            blk, rb = params[f"res_{i}_{j}"], f"resblocks.{n_res * i + j}"
            k = 0
            while f"convs1_{k}" in blk:
                for c in ("convs1", "convs2"):
                    sd.put(f"{rb}.{c}.{k}.weight", _conv1d(blk[f"{c}_{k}"]["kernel"]))
                    sd.put(f"{rb}.{c}.{k}.bias", blk[f"{c}_{k}"]["bias"])
                k += 1
    return dict(sd)


def discriminator_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``SpectrogramDiscriminator`` ``params`` (parity family, weight
    norm) -> the port's discriminator state_dict.  flax numbers its
    ``WeightNorm_i`` in call order: ``conv_prev`` 0, then ``spk_mlp`` where
    the discriminator was initialised with a speaker embedding, then
    ``conv_j``, ``post_0`` and ``post_1`` (without ``spk_mlp``,
    ``import_discriminator``'s order)."""
    n = 0
    while f"conv_{n}" in params:
        n += 1
    names = [("conv_prev", "conv_prev")]
    names += [("spk_mlp", "spk_mlp")] if "spk_mlp" in params else []
    names += [(f"conv_{i}", f"convs.{i}") for i in range(n)]
    names += [("post_0", "conv_post.0"), ("post_1", "conv_post.1")]
    sd = _SD()
    for idx, (fname, tname) in enumerate(names):
        scale = _a(params[f"WeightNorm_{idx}"][f"{fname}/kernel/scale"])
        if fname == "spk_mlp":  # Dense kernel (in, out) -> Linear (out, in)
            sd.put(tname + ".weight_g", scale.reshape(-1, 1))
            sd.put(tname + ".weight_v", _a(params[fname]["kernel"]).T)
        else:
            sd.put(tname + ".weight_g", scale.reshape(-1, 1, 1, 1))
            sd.put(tname + ".weight_v", _conv2d(params[fname]["kernel"]))
        sd.put(tname + ".bias", params[fname]["bias"])
    return dict(sd)


def utmos_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``UTMOSStrong`` ``params`` (``evaluation/ssl_mos.py``) -> the
    port's ``UTMOSStrong`` state_dict, the wav2vec2 encoder under
    ``wav2vec2.`` in HuggingFace's names.  The BiLSTM's folded bias ``b``
    becomes ``bias_ih`` with a zero ``bias_hh``; each 1-D embedding one row."""
    ssl, w = params["ssl"], "wav2vec2."
    sd = _SD()

    def norm(name, p):
        sd.put(name + ".weight", p["scale"])
        sd.put(name + ".bias", p["bias"])

    fe = ssl["feature_extractor"]
    i = 0
    while f"conv_{i}" in fe:
        sd.put(f"{w}feature_extractor.conv_layers.{i}.conv.weight",
               _conv1d(fe[f"conv_{i}"]["kernel"]))
        i += 1
    norm(w + "feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    norm(w + "feature_projection.layer_norm", ssl["feature_projection"]["layer_norm"])
    _linear(sd, w + "feature_projection.projection", ssl["feature_projection"]["projection"])
    pos = ssl["pos_conv_embed"]["conv"]
    sd.put(w + "encoder.pos_conv_embed.conv.weight", _conv1d(pos["kernel"]))
    sd.put(w + "encoder.pos_conv_embed.conv.bias", pos["bias"])
    norm(w + "encoder.layer_norm", ssl["encoder_layer_norm"])
    i = 0
    while f"layer_{i}" in ssl:
        p, pre = ssl[f"layer_{i}"], f"{w}encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, pre + "attention." + n, p[n])
        for n in ("intermediate_dense", "output_dense"):
            _linear(sd, pre + "feed_forward." + n, p[n])
        norm(pre + "layer_norm", p["layer_norm"])
        norm(pre + "final_layer_norm", p["final_layer_norm"])
        i += 1
    for n in ("domain_emb", "judge_emb"):
        sd.put(n + ".weight", _a(params[n]).reshape(1, -1))
    bl = params["blstm"]
    for tag, suf in (("fwd", ""), ("bwd", "_reverse")):
        sd.put(f"blstm.weight_ih_l0{suf}", _a(bl[f"w_ih_{tag}"]).T)
        sd.put(f"blstm.weight_hh_l0{suf}", _a(bl[f"w_hh_{tag}"]).T)
        sd.put(f"blstm.bias_ih_l0{suf}", bl[f"b_{tag}"])
        sd.put(f"blstm.bias_hh_l0{suf}", np.zeros_like(_a(bl[f"b_{tag}"])))
    _linear(sd, "projection.0", params["proj_in"])
    _linear(sd, "projection.2", params["proj_out"])
    return dict(sd)

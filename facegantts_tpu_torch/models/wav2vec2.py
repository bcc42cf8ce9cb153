"""wav2vec2-style SSL speech encoder, in torch.

Port of the JAX package's ``models/wav2vec2.py``: the wav2vec2 BASE
encoder (``feat_extract_norm="group"``) under the reference's UTMOS MOS
predictor (reference evaluation/eval.py:209-211, the UTMOS22 strong
learner; ``evaluation/ssl_mos.py`` holds the head and the importer).

- 7-layer strided 1-D conv feature encoder over raw 16 kHz waveform
  (dims 512, kernels 10/3/3/3/3/2/2, strides 5/2/2/2/2/2/2, no bias),
  GroupNorm(512, 512) after the first conv only, exact (erf) GELU
  everywhere -> ~49 frames/s.
- feature projection: LayerNorm -> Linear 512->768.
- convolutional relative positional embedding: grouped Conv1d (kernel 128,
  groups 16, padded K/2 on both sides with the trailing frame dropped for
  an even kernel), GELU, added to the input, then ``encoder.layer_norm``
  before the layers (the post-norm variant).
- N transformer encoder layers, post-norm: MHA(768, 12 heads), dense with
  no mask and scaled by 1/sqrt(d), + residual -> LayerNorm -> FFN(3072,
  GELU) + residual -> LayerNorm.

Parameter names follow HuggingFace's ``Wav2Vec2Model``
(``feature_extractor.conv_layers.N.conv``, ``...0.layer_norm`` for the
GroupNorm, ``feature_projection.{layer_norm,projection}``,
``encoder.pos_conv_embed.conv`` with a plain ``weight``,
``encoder.layer_norm``, ``encoder.layers.N.attention.{q,k,v,out}_proj``,
``encoder.layers.N.feed_forward.{intermediate,output}_dense``,
``encoder.layers.N.{layer_norm,final_layer_norm}``), so the port's
``state_dict`` is one that both packages' importers take.

Every norm uses ``eps=1e-6``: the JAX package never sets flax's epsilon,
whose default is 1e-6, where torch, HuggingFace and fairseq use 1e-5; the
port holds to the JAX package.  All sizes are constructor arguments so tests
can build tiny replicas; as in JAX, the conv kernels and strides are zipped
with ``conv_dims``, so fewer dims take the first kernels and strides.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-6  # flax's LayerNorm / GroupNorm default, which the JAX package keeps


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride, bias=False)
        # one group a channel, after the first conv only
        self.layer_norm = nn.GroupNorm(c_out, c_out, eps=EPS) if group_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.gelu(x)


class ConvFeatureEncoder(nn.Module):
    """Raw waveform (B, S) -> frame features (B, T, conv_dims[-1])."""

    def __init__(self, conv_dims: Sequence[int] = (512,) * 7,
                 kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)):
        super().__init__()
        dims = list(zip(conv_dims, kernels, strides))
        ins = [1] + [d for d, _, _ in dims[:-1]]
        self.conv_layers = nn.ModuleList(
            _ConvLayer(c_in, d, k, s, group_norm=i == 0)
            for i, (c_in, (d, k, s)) in enumerate(zip(ins, dims)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, conv_dim: int = 512, hidden: int = 768):
        super().__init__()
        self.layer_norm = nn.LayerNorm(conv_dim, eps=EPS)
        self.projection = nn.Linear(conv_dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class PositionalConvEmbedding(nn.Module):
    """Grouped temporal conv over (B, T, C), padded K/2 on both sides with
    the trailing frame dropped for an even kernel, then GELU."""

    def __init__(self, hidden: int = 768, kernel: int = 128, groups: int = 16):
        super().__init__()
        self.conv = nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x.transpose(1, 2))[:, :, : x.shape[1]]
        return F.gelu(h).transpose(1, 2)


class TransformerLayer(nn.Module):
    """Post-norm transformer encoder layer (wav2vec2 base variant)."""

    def __init__(self, hidden: int = 768, heads: int = 12, ffn: int = 3072):
        super().__init__()
        self.heads = heads
        self.attention = nn.ModuleDict(
            {k: nn.Linear(hidden, hidden) for k in ("q_proj", "k_proj", "v_proj", "out_proj")})
        self.layer_norm = nn.LayerNorm(hidden, eps=EPS)
        self.feed_forward = nn.ModuleDict({"intermediate_dense": nn.Linear(hidden, ffn),
                                           "output_dense": nn.Linear(ffn, hidden)})
        self.final_layer_norm = nn.LayerNorm(hidden, eps=EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        d = c // self.heads
        a = self.attention

        def split(h):
            return h.view(b, t, self.heads, d).transpose(1, 2)

        q, k, v = split(a["q_proj"](x)), split(a["k_proj"](x)), split(a["v_proj"](x))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        out = a["out_proj"]((att @ v).transpose(1, 2).reshape(b, t, c))
        x = self.layer_norm(x + out)
        f = self.feed_forward
        h = f["output_dense"](F.gelu(f["intermediate_dense"](x)))
        return self.final_layer_norm(x + h)


class Wav2Vec2Encoder(nn.Module):
    """Raw 16 kHz waveform (B, S) float -> SSL features (B, T, hidden)."""

    def __init__(self, hidden: int = 768, layers: int = 12, heads: int = 12, ffn: int = 3072,
                 conv_dims: Sequence[int] = (512,) * 7,
                 conv_kernels: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_strides: Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 pos_kernel: int = 128, pos_groups: int = 16):
        super().__init__()
        self.feature_extractor = ConvFeatureEncoder(conv_dims, conv_kernels, conv_strides)
        conv_dim = self.feature_extractor.conv_layers[-1].conv.out_channels
        self.feature_projection = FeatureProjection(conv_dim, hidden)
        self.encoder = nn.ModuleDict({
            "pos_conv_embed": PositionalConvEmbedding(hidden, pos_kernel, pos_groups),
            "layer_norm": nn.LayerNorm(hidden, eps=EPS),
            "layers": nn.ModuleList(TransformerLayer(hidden, heads, ffn) for _ in range(layers)),
        })

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feature_projection(self.feature_extractor(wav))
        enc = self.encoder
        x = enc["layer_norm"](x + enc["pos_conv_embed"](x))
        for layer in enc["layers"]:
            x = layer(x)
        return x

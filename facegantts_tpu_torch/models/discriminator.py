"""2-D spectrogram discriminator, in torch.

Port of the JAX package's ``models/discriminator.py`` (reference
model/discriminator.py:9-76), parity family with weight norm: the
log-mel is a one-channel image (B, 1, F, T) scored by ``conv_prev``, then
``num_layers`` (kh, kw) convolutions padded (1, ``padding``), then two 3x3
convolutions ``conv_post.{0,1}``, LeakyReLU between them.  Returns the
feature maps after ``conv_prev`` and each ladder convolution (NCHW), for
feature matching, and the flattened logits; with one output channel the
(F', T') flattening is the JAX NHWC reshape's order.

Parameter names are the reference torch ``state_dict``'s (``weight_g``,
``weight_v``, ``bias``), so ``train/checkpoint.py: import_discriminator``
reads them and ``convert.discriminator_state_dict`` writes them.  Built with
``spk_emb_dim > 0`` it also takes a speaker embedding (B, spk_emb_dim)
through the weight-normed ``spk_mlp`` Linear, added to every frequency row
and frame of ``conv_prev``'s channels (reference :57-59); neither GAN step
passes one, so ``from_config`` builds it without.  Not ported, and raising:
spectral norm, which the JAX package's GAN step cannot run (ROADMAP §3), and
the ``tpu_opt`` family (ROADMAP item 18).
"""

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

WN_EPS = 1e-12  # flax WeightNorm's epsilon, inside the rsqrt


class WNConv2d(nn.Module):
    """Conv2d with flax ``WeightNorm``'s reparametrisation: the kernel is
    ``weight_v`` over its per-output-channel L2 norm (eps inside the rsqrt),
    times ``weight_g``.  Initialised as flax initialises it: unit scale,
    zero bias, the direction from a normal of variance 1 / fan_in."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 padding: Tuple[int, int], stride: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.padding, self.stride = tuple(padding), tuple(stride)
        fan_in = in_ch * kernel[0] * kernel[1]
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.randn(out_ch, in_ch, *kernel) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * torch.rsqrt(v.square().sum(dim=(1, 2, 3), keepdim=True) + WN_EPS) * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight(), self.bias, self.stride, self.padding)


class WNLinear(nn.Module):
    """Linear with flax ``WeightNorm``'s reparametrisation over the input
    axis: ``weight_v`` (out, in) over its per-output L2 norm, times
    ``weight_g`` (out, 1), as torch ``weight_norm`` lays out a Linear."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.weight_v = nn.Parameter(torch.randn(out_features, in_features)
                                     / math.sqrt(in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = v * torch.rsqrt(v.square().sum(dim=1, keepdim=True) + WN_EPS) * self.weight_g
        return F.linear(x, w, self.bias)


class SpectrogramDiscriminator(nn.Module):
    def __init__(self, base_channels: int = 64, num_layers: int = 5, kernel_height: int = 12,
                 kernel_width: int = 5, stride: int = 1, padding: int = 6,
                 lrelu_slope: float = 0.3, use_spectral_norm: int = 0,
                 family: str = "parity", spk_emb_dim: int = 0):
        super().__init__()
        if use_spectral_norm:
            raise NotImplementedError(
                "use_spectral_norm=1: the JAX package's GAN step cannot run the spectral-norm "
                "discriminator, so the port has no reference for it (ROADMAP §3); use weight "
                "norm (use_spectral_norm=0)")
        if family != "parity":
            raise NotImplementedError(
                f"disc_family={family!r}: only the 'parity' discriminator is ported "
                "(the tpu_opt family is ROADMAP item 18)")
        self.slope = lrelu_slope
        kernel, pad = (kernel_height, kernel_width), (1, padding)
        self.conv_prev = WNConv2d(1, base_channels, kernel, pad)
        self.spk_mlp = WNLinear(spk_emb_dim, base_channels) if spk_emb_dim else None
        self.convs = nn.ModuleList([
            WNConv2d(base_channels, base_channels, kernel, pad, stride=(1, stride))
            for _ in range(num_layers)
        ])
        self.conv_post = nn.ModuleList([
            WNConv2d(base_channels, base_channels, (3, 3), (1, 1)),
            WNConv2d(base_channels, 1, (3, 3), (1, 1)),
        ])

    @staticmethod
    def from_config(cfg) -> "SpectrogramDiscriminator":
        return SpectrogramDiscriminator(
            base_channels=cfg.disc_base_channels, num_layers=cfg.disc_num_layers,
            kernel_height=cfg.kernel_height, kernel_width=cfg.kernel_width,
            stride=cfg.disc_stride, padding=cfg.disc_padding,
            lrelu_slope=cfg.disc_lrelu_slope, use_spectral_norm=cfg.use_spectral_norm,
            family=cfg.disc_family,
        )

    def forward(self, x: torch.Tensor, speaker_emb: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """x (B, 1, F, T), speaker_emb (B, spk_emb_dim) or None -> (feature
        maps, logits (B, F' * T'))."""
        fmap = []
        h = F.leaky_relu(self.conv_prev(x), self.slope)
        fmap.append(h)
        if speaker_emb is not None:
            if self.spk_mlp is None:
                raise ValueError("this discriminator was built without a speaker input "
                                 "(spk_emb_dim=0)")
            h = h + self.spk_mlp(speaker_emb)[:, :, None, None]
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.slope)
            fmap.append(h)
        h = F.leaky_relu(self.conv_post[0](h), self.slope)
        h = self.conv_post[1](h)
        return fmap, h.flatten(1)

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
reads them and ``convert.discriminator_state_dict`` writes them.  Not
ported yet, and raising: spectral norm, the speaker-embedding input
(ROADMAP item 12) and the ``tpu_opt`` family (ROADMAP item 18).
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


class SpectrogramDiscriminator(nn.Module):
    def __init__(self, base_channels: int = 64, num_layers: int = 5, kernel_height: int = 12,
                 kernel_width: int = 5, stride: int = 1, padding: int = 6,
                 lrelu_slope: float = 0.3, use_spectral_norm: int = 0,
                 family: str = "parity"):
        super().__init__()
        if use_spectral_norm:
            raise NotImplementedError(
                "use_spectral_norm=1: the spectral-norm discriminator is not ported yet "
                "(ROADMAP item 12); use weight norm (use_spectral_norm=0)")
        if family != "parity":
            raise NotImplementedError(
                f"disc_family={family!r}: only the 'parity' discriminator is ported "
                "(the tpu_opt family is ROADMAP item 18)")
        self.slope = lrelu_slope
        kernel, pad = (kernel_height, kernel_width), (1, padding)
        self.conv_prev = WNConv2d(1, base_channels, kernel, pad)
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
        """x (B, 1, F, T) -> (feature maps, logits (B, F' * T'))."""
        if speaker_emb is not None:
            raise NotImplementedError(
                "the discriminator's speaker-embedding input is not ported yet (ROADMAP "
                "item 12); the GAN step calls it without one")
        fmap = []
        h = F.leaky_relu(self.conv_prev(x), self.slope)
        fmap.append(h)
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.slope)
            fmap.append(h)
        h = F.leaky_relu(self.conv_post[0](h), self.slope)
        h = self.conv_post[1](h)
        return fmap, h.flatten(1)

"""Score-based diffusion decoder (Grad-TTS SDE), in torch.

Port of the JAX package's ``models/diffusion.py`` (reference
model/diffusion.py:151-262): the linear beta(t) schedule, the Euler reverse
sampler over the parity U-Net (the JAX ``lax.scan`` is a Python loop here),
and the training side: ``forward_diff``, the score-matching ``loss_t`` with
the one-step denoised x_t used by the speaker-binding loss, and
``compute_loss``.  The diffusion time ``t`` and the normal ``z`` can be
injected (tests feed both frameworks the same draws); otherwise they come
from a ``torch.Generator``.
"""

from typing import Optional

import torch
from torch import nn

from facegantts_tpu_torch.models.unet import GradLogPEstimator2d


def noise_level(t, beta_min: float, beta_max: float, cumulative: bool = False):
    """beta(t) or its integral from 0 to t (reference diffusion.py:181-186)."""
    if cumulative:
        return beta_min * t + 0.5 * (beta_max - beta_min) * t**2
    return beta_min + (beta_max - beta_min) * t


class Diffusion(nn.Module):
    """Wraps the score estimator with the reverse-SDE sampler."""

    def __init__(self, n_feats: int, dim: int, multi_spks: int = 1, spk_emb_dim: int = 512,
                 beta_min: float = 0.05, beta_max: float = 20.0, pe_scale: float = 1000.0,
                 fused_gn: int = 1, unet_family: str = "parity", perceptual_loss: int = 1):
        super().__init__()
        if unet_family != "parity":
            raise ValueError(
                f"unet_family {unet_family!r}: the PyTorch port has only the "
                "'parity' U-Net so far")
        self.n_feats, self.beta_min, self.beta_max = n_feats, beta_min, beta_max
        self.perceptual_loss = perceptual_loss
        self.estimator = GradLogPEstimator2d(
            dim=dim, multi_spks=multi_spks, spk_emb_dim=spk_emb_dim, n_feats=n_feats,
            pe_scale=pe_scale, fused_gn=fused_gn,
        )

    def reverse_diff(
        self,
        z: torch.Tensor,  # (B, F, T) initial noise around mu
        mask: torch.Tensor,  # (B, 1, T)
        mu: torch.Tensor,  # (B, F, T)
        n_steps: int,
        stoc: bool = False,
        spk: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Euler reverse sampler (reference diffusion.py:204-236).

        ``stoc=True`` adds per-step noise drawn from ``generator``."""
        h = 1.0 / n_steps
        xt = z * mask
        b = z.shape[0]
        for i in range(n_steps):
            # f32 arithmetic, as the JAX sampler computes t
            step = torch.full((b,), float(i), dtype=torch.float32, device=z.device)
            t = (1.0 - (step + 0.5) * h).to(z.dtype)
            beta_t = noise_level(t[:, None, None], self.beta_min, self.beta_max)
            score = self.estimator(xt, mask, mu, t, spk)
            if stoc:
                dxt_det = (0.5 * (mu - xt) - score) * beta_t * h
                noise = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                                    device=z.device)
                dxt = dxt_det + noise * torch.sqrt(beta_t * h)
            else:
                dxt = 0.5 * (mu - xt - score) * beta_t * h
            xt = (xt - dxt) * mask
        return xt

    def forward(self, z, mask, mu, n_steps, stoc=False, spk=None, generator=None):
        return self.reverse_diff(z, mask, mu, n_steps, stoc, spk, generator)

    def forward_diff(self, x0, mask, mu, t, z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Diffuse x0 toward mu at times t (reference diffusion.py:188-202).

        Returns (x_t, z) with z the standard normal used, both masked."""
        cum = noise_level(t[:, None, None], self.beta_min, self.beta_max, cumulative=True)
        decay = torch.exp(-0.5 * cum)
        mean = x0 * decay + mu * (1.0 - decay)
        var = 1.0 - torch.exp(-cum)
        if z is None:
            z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
        xt = mean + z * torch.sqrt(var)
        return xt * mask, z * mask

    def loss_t(self, x0, mask, mu, t, spk=None, z=None, generator=None):
        """Score-matching loss at times t (reference diffusion.py:242-255).

        Returns (loss, x_t, x_t_hat); x_t_hat is the one-step denoised
        estimate (None without the perceptual loss)."""
        xt, z = self.forward_diff(x0, mask, mu, t, z, generator)
        cum = noise_level(t[:, None, None], self.beta_min, self.beta_max, cumulative=True)
        score = self.estimator(xt, mask, mu, t, spk)
        pred_noise = score * torch.sqrt(1.0 - torch.exp(-cum))
        loss = torch.sum((pred_noise + z) ** 2) / (torch.sum(mask) * self.n_feats)
        if not self.perceptual_loss:
            return loss, xt, None
        dxt = 0.5 * (mu - xt - score) * cum
        return loss, xt, (xt - dxt) * mask

    def compute_loss(self, x0, mask, mu, spk=None, offset: float = 1e-5,
                     t: Optional[torch.Tensor] = None, z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """t ~ U(offset, 1 - offset) unless given, then :meth:`loss_t`
        (reference diffusion.py:257-262)."""
        if t is None:
            u = torch.rand((x0.shape[0],), generator=generator, dtype=x0.dtype,
                           device=x0.device)
            t = offset + u * (1.0 - 2 * offset)
        return self.loss_t(x0, mask, mu, t.to(x0.dtype), spk, z, generator)

"""FaceTTS generator: text + face -> mel-spectrogram, in torch.

Port of the JAX package's ``models/facetts.py`` (reference
model/face_tts.py:27-241): TextEncoder -> ceiled durations -> hard alignment
-> diffusion decoder, conditioned on the SyncNet face (or voice) embedding,
and the four-part training loss of ``compute_loss`` (duration, prior,
diffusion, speaker binding).  The public methods keep the JAX layouts:
``encode`` returns ``mu_x`` (B, Tx, F), ``w_ceil`` (B, Tx, 1), ``x_mask``
(B, Tx, 1), ``y_lengths`` (B,) and ``spk_e``; ``decode`` returns mels
(B, F, Ty); ``compute_loss`` takes mels (B, F, Ty).
"""

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.models.diffusion import Diffusion
from facegantts_tpu_torch.models.syncnet import SyncNet
from facegantts_tpu_torch.models.text_encoder import TextEncoder
from facegantts_tpu_torch.ops.align import duration_loss, generate_path, sequence_mask
from facegantts_tpu_torch.ops.mas import maximum_path
from facegantts_tpu_torch.text.symbols import symbols
from facegantts_tpu_torch.train.precision import einsum


class LossParts(NamedTuple):
    dur_loss: torch.Tensor
    prior_loss: torch.Tensor
    diff_loss: torch.Tensor
    spk_loss: torch.Tensor  # already gamma-weighted (reference face_tts.py:240)

    @property
    def total(self):
        return self.dur_loss + self.prior_loss + self.diff_loss + self.spk_loss


class FaceTTS(nn.Module):
    """Generator model.  Build with :meth:`from_config`.

    SyncNet stays in eval mode whatever mode the model is in; ``train()``
    makes the encoder's dropout live, as the JAX package's
    ``deterministic=False``."""

    def __init__(self, n_vocab: int, n_feats: int, n_enc_channels: int, filter_channels: int,
                 filter_channels_dp: int, n_heads: int, n_enc_layers: int, enc_kernel: int,
                 enc_dropout: float, window_size: int, dec_dim: int, beta_min: float,
                 beta_max: float, pe_scale: float, vid_emb_dim: int = 512, n_spks: int = 2,
                 spk_emb: str = "face", syncnet_stride: int = 1,
                 syncnet_width_mult: float = 1.0, fused_gn: int = 1,
                 unet_family: str = "parity", gamma: float = 0.02,
                 perceptual_loss: int = 1):
        super().__init__()
        if spk_emb not in ("face", "speech"):
            raise ValueError(f"spk_emb={spk_emb!r}: expected 'face' or 'speech'")
        self.spk_emb, self.n_feats = spk_emb, n_feats
        self.gamma, self.perceptual_loss = gamma, perceptual_loss
        multi_spks = 1 if n_spks > 1 else 0
        self.encoder = TextEncoder(
            n_vocab=n_vocab, n_feats=n_feats, n_channels=n_enc_channels,
            filter_channels=filter_channels, filter_channels_dp=filter_channels_dp,
            n_heads=n_heads, n_layers=n_enc_layers, kernel_size=enc_kernel,
            p_dropout=enc_dropout, window_size=window_size, spk_emb_dim=vid_emb_dim,
            multi_spks=multi_spks,
        )
        self.decoder = Diffusion(
            n_feats=n_feats, dim=dec_dim, multi_spks=multi_spks, spk_emb_dim=vid_emb_dim,
            beta_min=beta_min, beta_max=beta_max, pe_scale=pe_scale, fused_gn=fused_gn,
            unet_family=unet_family, perceptual_loss=perceptual_loss,
        )
        self.syncnet = SyncNet(n_out=vid_emb_dim, stride=syncnet_stride,
                               width_mult=syncnet_width_mult)

    @staticmethod
    def from_config(cfg: Config) -> "FaceTTS":
        n_vocab = len(symbols) + 1 if cfg.add_blank else len(symbols)
        return FaceTTS(
            n_vocab=n_vocab, n_feats=cfg.n_feats, n_enc_channels=cfg.n_enc_channels,
            filter_channels=cfg.filter_channels, filter_channels_dp=cfg.filter_channels_dp,
            n_heads=cfg.n_heads, n_enc_layers=cfg.n_enc_layers, enc_kernel=cfg.enc_kernel,
            enc_dropout=cfg.enc_dropout, window_size=cfg.window_size, dec_dim=cfg.dec_dim,
            beta_min=cfg.beta_min, beta_max=cfg.beta_max, pe_scale=cfg.pe_scale,
            vid_emb_dim=cfg.vid_emb_dim, spk_emb=cfg.spk_emb,
            syncnet_stride=cfg.syncnet_stride, syncnet_width_mult=cfg.syncnet_width_mult,
            fused_gn=cfg.fused_gn_mish, unet_family=cfg.unet_family, gamma=cfg.gamma,
            perceptual_loss=cfg.perceptual_loss,
        )

    def speaker_embedding(self, spk: torch.Tensor) -> torch.Tensor:
        """Condition from a (B, 224, 224, 3) face or, with ``spk_emb="speech"``,
        a (B, n_mels, T) mel clip -> (B, vid_emb_dim), no gradient
        (reference face_tts.py:108-114, 148-155)."""
        if self.spk_emb == "speech":
            return self.syncnet.forward_aud(spk[:, None]).mean(dim=1).detach()
        return self.syncnet.forward_vid(spk).detach()

    def encode(self, x, x_lengths, spk=None, length_scale: float = 1.0,
               spk_is_embedding: bool = False):
        """Phase 1: text + face -> prior means, ceiled durations, mel lengths."""
        spk_e = spk if spk_is_embedding else self.speaker_embedding(spk)
        mu_x, logw, x_mask = self.encoder(x, x_lengths, spk_e)
        # exp and ceil in f32 also for a bf16 model, as XLA's fused bf16
        # code computes them: a bf16-rounded exp that lands on an integer
        # from above would ceil one frame short
        w = torch.exp(logw.float()) * x_mask
        w_ceil = (torch.ceil(w) * length_scale).to(logw.dtype)  # the reference scales after ceil
        y_lengths = torch.clamp(w_ceil.sum(dim=(1, 2)), min=1.0)
        return mu_x, w_ceil, x_mask, y_lengths, spk_e

    def decode(self, mu_x, w_ceil, x_mask, y_lengths, spk_e, n_timesteps: int,
               y_max_length: int, temperature: float = 1.0, stoc: bool = False,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None):
        """Phase 2: expand the prior along the durations and run the reverse
        diffusion at a mel bucket of ``y_max_length`` frames.

        ``noise``: optional standard-normal (B, F, y_max_length) in place of
        the draw from ``generator`` -- tests feed both frameworks the same.
        Returns (mu_y, mel, attn, y_lengths)."""
        y_lengths = torch.clamp(y_lengths, max=float(y_max_length)).to(torch.int32)
        y_mask = sequence_mask(y_lengths, y_max_length).to(mu_x.dtype)[:, None, :]
        attn_mask = x_mask * y_mask  # (B, Tx, Ty)
        attn = generate_path(w_ceil[..., 0], attn_mask)
        mu_y = einsum("bxy,bxf->bfy", attn, mu_x).to(mu_x.dtype)  # (B, F, Ty)
        if noise is None:
            noise = torch.randn(mu_y.shape, generator=generator, dtype=torch.float32,
                                device=mu_y.device)
        z = mu_y + noise.to(mu_y.device, mu_y.dtype) / temperature
        dec = self.decoder(z, y_mask, mu_y, n_timesteps, stoc, spk_e, generator)
        return mu_y, dec, attn, y_lengths

    def forward(self, x, x_lengths, n_timesteps: int, y_max_length: int,
                temperature: float = 1.0, stoc: bool = False, spk=None,
                length_scale: float = 1.0, generator=None, spk_is_embedding: bool = False,
                noise=None):
        """Inference: mel from text and a face (reference face_tts.py:92-140)."""
        mu_x, w_ceil, x_mask, y_lengths, spk_e = self.encode(
            x, x_lengths, spk, length_scale, spk_is_embedding)
        return self.decode(mu_x, w_ceil, x_mask, y_lengths, spk_e, n_timesteps,
                           y_max_length, temperature, stoc, generator, noise)

    def compute_loss(self, x, x_lengths, y, y_lengths, spk, out_size: Optional[int] = None,
                     offset: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Duration + prior + diffusion + speaker-binding losses
        (reference face_tts.py:142-241; JAX package ``compute_loss``).

        x (B, Tx) ids, y (B, F, Ty) mels, spk the faces (unused with
        ``spk_emb="speech"``, which conditions on y).  The draws can be
        injected: ``offset`` (B,) the crop starts, ``t`` (B,) the diffusion
        times, ``z`` (B, F, out_size) the normal; otherwise they come from
        ``generator``.  Dropout follows the module's mode.
        Returns (LossParts, aux dict)."""
        # not detached: gradients reach the SyncNet stream that conditions,
        # and the optimizer decides what updates (train/optim.py)
        if self.spk_emb == "speech":
            spk_e = self.syncnet.forward_aud(y[:, None]).mean(dim=1)
        else:
            spk_e = self.syncnet.forward_vid(spk)

        mu_x, logw, x_mask = self.encoder(x, x_lengths, spk_e)
        y_max_length = y.shape[-1]
        y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)[:, None, :]
        attn_mask = x_mask * y_mask  # (B, Tx, Ty)

        # Gaussian log-prior over (text, mel) pairs and MAS, no gradient
        # (reference face_tts.py:165-171)
        with torch.no_grad():
            mu_sg = mu_x.detach()
            const = -0.5 * math.log(2 * math.pi) * self.n_feats
            # for a bf16 model as JAX computes it: y_mu in f32 (the package's
            # preferred_element_type), the squared norms summed in f32 and
            # rounded to bf16 once (XLA keeps a fused chain in f32), so that
            # the path does not turn on roundings of its own
            y_sq = torch.sum(-0.5 * y.float()**2, dim=1).to(y.dtype)[:, None, :]  # (B, 1, Ty)
            y_mu = torch.einsum("bxf,bfy->bxy", mu_sg.float(), y.float())
            mu_sq = torch.sum(-0.5 * mu_sg.float()**2, dim=-1).to(mu_sg.dtype)[:, :, None]
            log_prior = y_sq + y_mu + mu_sq + const
            attn = maximum_path(log_prior.contiguous(), attn_mask.contiguous())

        logw_ = torch.log(1e-8 + torch.sum(attn, dim=-1))[:, :, None] * x_mask
        dur_loss = duration_loss(logw, logw_, x_lengths)

        # random 2-second crop (face_tts.py:181-215)
        if out_size is not None and out_size < y_max_length:
            if offset is None:
                u = torch.rand((y.shape[0],), generator=generator, device=y.device)
                max_offset = torch.clamp(y_lengths - out_size, min=0)
                offset = (u * max_offset).to(torch.int32)
            cols = offset.to(y.device).long()[:, None, None] + torch.arange(
                out_size, device=y.device)
            y = torch.take_along_dim(y, cols.expand(-1, y.shape[1], -1), dim=2)
            attn = torch.take_along_dim(attn, cols.expand(-1, attn.shape[1], -1), dim=2)
            y_cut_lengths = torch.clamp(y_lengths, max=out_size)
            y_mask = sequence_mask(y_cut_lengths, out_size).to(y_mask.dtype)[:, None, :]

        # one text row a frame: mu_y holds mu_x's values exactly, in its dtype
        mu_y = einsum("bxy,bxf->bfy", attn.to(mu_x.dtype), mu_x)

        diff_loss, xt, xt_hat = self.decoder.compute_loss(
            y, y_mask, mu_y, spk_e, t=t, z=z, generator=generator)

        # speaker-binding perceptual loss over SyncNet audio features
        # (face_tts.py:225-230): maps i >= 2, averaged over all 8
        spk_loss = torch.zeros((), device=y.device)
        if self.perceptual_loss:
            out_f = self.syncnet.forward_perceptual(xt_hat[:, None])
            with torch.no_grad():
                gt_f = self.syncnet.forward_perceptual(y[:, None])
            for i in range(2, len(out_f)):
                spk_loss = spk_loss + torch.mean(torch.abs(out_f[i] - gt_f[i]))
            spk_loss = spk_loss / float(len(out_f))

        prior_loss = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask) / (
            torch.sum(y_mask) * self.n_feats)

        parts = LossParts(dur_loss=dur_loss, prior_loss=prior_loss, diff_loss=diff_loss,
                          spk_loss=self.gamma * spk_loss)
        aux = {"attn": attn, "xt_hat": xt_hat, "spk_e": spk_e, "y_cut": y,
               "y_cut_mask": y_mask, "mu_y": mu_y}
        return parts, aux

"""Text encoder: phoneme ids -> prior mel statistics + log-durations, in torch.

Port of the JAX package's ``models/text_encoder.py`` (reference
model/text_encoder.py:13-422): scaled embedding, 3-layer ConvReluNorm
prenet with a zero-initialised residual projection, broadcast speaker
embedding, transformer with +-window relative-position self-attention, the
mel-prior projection and the duration predictor on a detached input.

Inside, tensors are (B, C, T) as torch's Conv1d expects, and parameter names
follow the reference's torch ``state_dict``.  The public call keeps the JAX
layouts: ``mu`` (B, T, n_feats), ``logw`` (B, T, 1), ``x_mask`` (B, T, 1).
"""

import math
from typing import Optional

import torch
from torch import nn

from facegantts_tpu_torch.ops.align import sequence_mask
from facegantts_tpu_torch.train.precision import einsum


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), eps 1e-4
    (reference model/text_encoder.py:13-31)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = (x - mean).square().mean(1, keepdim=True)
        x = (x - mean) * torch.rsqrt(var + self.eps)
        return x * self.gamma[None, :, None] + self.beta[None, :, None]


class ConvReluNorm(nn.Module):
    """Masked conv prenet with a zero-initialised residual projection
    (reference model/text_encoder.py:34-82)."""

    def __init__(self, channels: int, kernel_size: int = 5, n_layers: int = 3,
                 p_dropout: float = 0.5):
        super().__init__()
        self.conv_layers = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=kernel_size // 2)
            for _ in range(n_layers)
        ])
        self.norm_layers = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])
        self.drop = nn.Dropout(p_dropout)
        self.proj = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x, x_mask):
        x_org = x
        for conv, norm in zip(self.conv_layers, self.norm_layers):
            x = self.drop(torch.relu(norm(conv(x * x_mask))))
        return (x_org + self.proj(x)) * x_mask


class DurationPredictor(nn.Module):
    """Two masked conv blocks + scalar projection in the log domain
    (reference model/text_encoder.py:85-113)."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        pad = kernel_size // 2
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = nn.Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.norm_1 = ChannelLayerNorm(filter_channels)
        self.conv_2 = nn.Conv1d(filter_channels, filter_channels, kernel_size, padding=pad)
        self.norm_2 = ChannelLayerNorm(filter_channels)
        self.proj = nn.Conv1d(filter_channels, 1, 1)

    def forward(self, x, x_mask):
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


class WindowedSelfAttention(nn.Module):
    """Multi-head self-attention with +-window relative-position embeddings
    shared across heads, on keys and values (reference
    model/text_encoder.py:116-257).  One formulation for every batch size:
    the relative logits (B, H, T, 2w+1) are placed on the band |s - t| <= w
    of the (T, T) scores with a gather, and the attention weights on that
    band are gathered back for the value table; outside the band both
    contribute exactly zero, as the reference's zero-padded tables do."""

    def __init__(self, channels: int, n_heads: int, window_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.h, self.w = n_heads, window_size
        self.d = channels // n_heads
        self.conv_q = nn.Conv1d(channels, channels, 1)
        self.conv_k = nn.Conv1d(channels, channels, 1)
        self.conv_v = nn.Conv1d(channels, channels, 1)
        self.conv_o = nn.Conv1d(channels, channels, 1)
        self.drop = nn.Dropout(p_dropout)
        std = self.d**-0.5
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.d) * std)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, self.d) * std)

    def forward(self, x, attn_mask):
        # x: (B, C, T); attn_mask: (B, T, T), rows are queries
        b, c, t = x.shape
        h, d, w = self.h, self.d, self.w
        q = self.conv_q(x).view(b, h, d, t)
        k = self.conv_k(x).view(b, h, d, t)
        v = self.conv_v(x).view(b, h, d, t)
        scale = 1.0 / math.sqrt(d)
        scores = einsum("bhdt,bhds->bhts", q, k) * scale

        pos = torch.arange(t, device=x.device)
        delta = pos[None, :] - pos[:, None]  # (t_q, t_k) = s - t
        in_win = delta.abs() <= w
        r_idx = (delta + w).clamp(0, 2 * w)
        rel_q = einsum("bhdt,rd->bhtr", q, self.emb_rel_k[0])  # (B, H, T, 2w+1)
        rel_scores = rel_q.gather(-1, r_idx.expand(b, h, t, t))
        scores = scores + (rel_scores * scale).masked_fill(~in_win, 0.0)
        scores = scores.masked_fill(attn_mask[:, None] == 0, -1e4)
        p = self.drop(scores.softmax(-1))
        out = einsum("bhts,bhds->bhdt", p, v)

        # relative values: rel_w[b, h, t, r] = p[b, h, t, t + r - w]
        r = torch.arange(2 * w + 1, device=x.device)
        s = pos[:, None] + r[None, :] - w
        valid = (s >= 0) & (s <= t - 1)
        rel_w = p.gather(-1, s.clamp(0, t - 1).expand(b, h, t, 2 * w + 1))
        rel_w = rel_w.masked_fill(~valid, 0.0)
        out = out + einsum("bhtr,rd->bhdt", rel_w, self.emb_rel_v[0])
        return self.conv_o(out.reshape(b, c, t))


class FFN(nn.Module):
    """Masked conv feed-forward (reference model/text_encoder.py:260-284)."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        pad = kernel_size // 2
        self.conv_1 = nn.Conv1d(channels, filter_channels, kernel_size, padding=pad)
        self.conv_2 = nn.Conv1d(filter_channels, channels, kernel_size, padding=pad)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask):
        x = self.drop(torch.relu(self.conv_1(x * x_mask)))
        return self.conv_2(x) * x_mask


class TransformerEncoder(nn.Module):
    """Pre-mask transformer stack (reference model/text_encoder.py:287-346)."""

    def __init__(self, channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float, window_size: int):
        super().__init__()
        self.attn_layers = nn.ModuleList([
            WindowedSelfAttention(channels, n_heads, window_size, p_dropout)
            for _ in range(n_layers)
        ])
        self.ffn_layers = nn.ModuleList([
            FFN(channels, filter_channels, kernel_size, p_dropout) for _ in range(n_layers)
        ])
        self.norm_layers_1 = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])
        self.norm_layers_2 = nn.ModuleList([ChannelLayerNorm(channels) for _ in range(n_layers)])
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x, x_mask):
        attn_mask = x_mask.transpose(1, 2) * x_mask  # (B, T, T)
        for attn, ffn, n1, n2 in zip(self.attn_layers, self.ffn_layers,
                                     self.norm_layers_1, self.norm_layers_2):
            x = x * x_mask
            x = n1(x + self.drop(attn(x, attn_mask)))
            x = n2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask


class TextEncoder(nn.Module):
    """Full text encoder (reference model/text_encoder.py:349-422)."""

    def __init__(self, n_vocab: int, n_feats: int, n_channels: int, filter_channels: int,
                 filter_channels_dp: int, n_heads: int, n_layers: int, kernel_size: int,
                 p_dropout: float, window_size: int, spk_emb_dim: int = 512,
                 multi_spks: int = 1):
        super().__init__()
        self.n_channels, self.multi_spks = n_channels, multi_spks
        self.emb = nn.Embedding(n_vocab, n_channels)
        nn.init.normal_(self.emb.weight, 0.0, n_channels**-0.5)
        self.prenet = ConvReluNorm(n_channels, kernel_size=5, n_layers=3, p_dropout=0.5)
        width = n_channels + (spk_emb_dim if multi_spks else 0)
        self.encoder = TransformerEncoder(width, filter_channels, n_heads, n_layers,
                                          kernel_size, p_dropout, window_size)
        self.proj_m = nn.Conv1d(width, n_feats, 1)
        self.proj_w = DurationPredictor(width, filter_channels_dp, kernel_size, p_dropout)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                spk: Optional[torch.Tensor] = None):
        """x: (B, T) ids; x_lengths: (B,); spk: (B, spk_emb_dim).
        Returns mu (B, T, n_feats), logw (B, T, 1), x_mask (B, T, 1)."""
        t = x.shape[1]
        h = (self.emb(x) * math.sqrt(self.n_channels)).transpose(1, 2)  # (B, C, T)
        x_mask = sequence_mask(x_lengths, t).to(h.dtype)[:, None, :]  # (B, 1, T)
        h = self.prenet(h, x_mask)
        if self.multi_spks:
            h = torch.cat([h, spk.to(h.dtype)[:, :, None].expand(-1, -1, t)], dim=1)
        h = self.encoder(h, x_mask)
        mu = self.proj_m(h) * x_mask
        logw = self.proj_w(h.detach(), x_mask)  # the duration head never trains the trunk
        return mu.transpose(1, 2), logw.transpose(1, 2), x_mask.transpose(1, 2)

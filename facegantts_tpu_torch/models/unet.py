"""U-Net score estimator for the diffusion decoder, in torch (NCHW).

Port of the JAX package's parity ``GradLogPEstimator2d`` and its blocks
(reference model/diffusion.py:33-148, model/baseblock.py:9-104).  Module and
parameter names follow the reference's torch ``state_dict``, so reference
checkpoints load with ``load_state_dict``.  The public call keeps the JAX
layouts: ``x, mu`` (B, F, T), ``mask`` (B, 1, T); inside, the stack
``[mu, x, spk-map]`` is the channel axis of a (B, 3, F, T) image.

With ``fused_gn`` set, every ``Block`` runs its GroupNorm -> Mish -> time
mask chain as kernel K1 (``ops/gn_mish.py``) with per-item frame counts
``lens`` in place of a mask tensor.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from facegantts_tpu_torch.ops.gn_mish import gn_mish_mask, mish_f32
from facegantts_tpu_torch.ops.groupnorm import group_norm
from facegantts_tpu_torch.train.precision import einsum


def mish(x: torch.Tensor) -> torch.Tensor:
    """x * tanh(softplus(x)) in the JAX package's rational-exp form (clamp at
    20), computed in f32 and returned in x's dtype.  ``F.mish`` differs from
    it by up to 4e-6."""
    return mish_f32(x.float()).to(x.dtype)


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


class FusedGroupNorm(nn.Module):
    """GroupNorm whose statistics come from kernel K2 (``ops/groupnorm.py``),
    over NCHW (B, C, F, T), eps 1e-5.  Parameters and math are those of
    ``nn.GroupNorm`` (``weight``, ``bias``).

    As in the JAX package (``models/unet.py: FusedGroupNorm``), no model
    uses it."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.groups, 1e-5)


def timestep_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal positions for diffusion time (reference diffusion.py:19-30),
    in t's dtype: the JAX package's frequencies are a weakly typed f32, so a
    bf16 t gives bf16 arguments and a bf16 embedding there too."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, device=t.device, dtype=torch.float32)
        / (half - 1)
    )
    args = scale * t[:, None] * freqs[None, :].to(t.dtype)
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Block(nn.Module):
    """conv3x3 -> GroupNorm(8) -> Mish, masked (reference baseblock.py:42-51).

    ``block.0`` is the conv and ``block.1`` the GroupNorm (eps 1e-5), as in
    the reference's ``nn.Sequential``."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, fused: bool = False):
        super().__init__()
        self.groups = groups
        self.fused = fused
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim_out, 3, padding=1),
            nn.GroupNorm(groups, dim_out, eps=1e-5),
            Mish(),
        )

    def forward(self, x, mask, lens: Optional[torch.Tensor] = None):
        conv, norm = self.block[0], self.block[1]
        h = conv(x * mask)
        if self.fused and lens is not None:
            return gn_mish_mask(h, norm.weight.float(), norm.bias.float(), lens,
                                self.groups, norm.eps)
        return mish(norm(h)) * mask


class ResnetBlock(nn.Module):
    """Two Blocks with a time-embedding injection and a residual 1x1 conv
    (reference baseblock.py:54-71)."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 fused: bool = False):
        super().__init__()
        self.mlp = nn.Sequential(Mish(), nn.Linear(time_emb_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups, fused)
        self.block2 = Block(dim_out, dim_out, groups, fused)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, mask, time_emb, lens=None):
        h = self.block1(x, mask, lens)
        h = h + self.mlp(time_emb)[:, :, None, None].to(h.dtype)
        h = self.block2(h, mask, lens)
        return h + self.res_conv(x * mask)


class LinearAttention(nn.Module):
    """Softmax-key linear attention over the (freq, time) grid
    (reference baseblock.py:74-94), per head."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, f, t = x.shape
        qkv = self.to_qkv(x).reshape(b, 3, self.heads, self.dim_head, f * t)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (B, H, D, N)
        k = k.softmax(dim=-1)  # over spatial positions
        ctx = einsum("bhdn,bhen->bhde", k, v)
        out = einsum("bhde,bhdn->bhen", ctx, q).to(x.dtype)
        return self.to_out(out.reshape(b, self.heads * self.dim_head, f, t))


class Rezero(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        y = self.fn(x)
        # the promotion made explicit: an f32 y times a bf16 g (train_bf16)
        # would run torch's slower mixed-dtype kernel
        return y * self.g.to(torch.promote_types(y.dtype, self.g.dtype))


class Residual(nn.Module):
    """x + Rezero(LinearAttention)(x); parameters at ``fn.fn.*`` and ``fn.g``
    (reference baseblock.py:32-39, 97-104)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class Downsample(nn.Module):
    """conv3x3, stride 2, padding 1 over (freq, time) (baseblock.py:23-29)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """ConvTranspose2d(4, 2, 1): doubles (freq, time) (baseblock.py:14-20)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class GradLogPEstimator2d(nn.Module):
    """Score-estimator U-Net (reference model/diffusion.py:33-148): three
    resolution levels with dims dim*(1, 2, 4), linear-attention residuals
    at every level; returns the predicted score (B, n_feats, T)."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4), groups: int = 8,
                 multi_spks: int = 1, spk_emb_dim: int = 512, n_feats: int = 128,
                 pe_scale: float = 1000.0, fused_gn: int = 1):
        super().__init__()
        self.dim, self.multi_spks, self.pe_scale = dim, multi_spks, pe_scale
        self.fused_gn = bool(fused_gn)
        fused = self.fused_gn
        if multi_spks:
            self.spk_mlp = nn.Sequential(
                nn.Linear(spk_emb_dim, spk_emb_dim * 4), Mish(),
                nn.Linear(spk_emb_dim * 4, n_feats))
        self.mlp = nn.Sequential(nn.Linear(dim, dim * 4), Mish(), nn.Linear(dim * 4, dim))

        dims = [3 if multi_spks else 2, *[dim * m for m in dim_mults]]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_out, dim, groups, fused),
                ResnetBlock(d_out, d_out, dim, groups, fused),
                Residual(Rezero(LinearAttention(d_out))),
                nn.Identity() if last else Downsample(d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, dim, groups, fused)
        self.mid_attn = Residual(Rezero(LinearAttention(mid)))
        self.mid_block2 = ResnetBlock(mid, mid, dim, groups, fused)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out * 2, d_in, dim, groups, fused),
                ResnetBlock(d_in, d_in, dim, groups, fused),
                Residual(Rezero(LinearAttention(d_in))),
                Upsample(d_in),
            ]))
        self.final_block = Block(dim, dim, groups, fused)
        self.final_conv = nn.Conv2d(dim, 1, 1)

    def forward(self, x, mask, mu, t, spk=None):
        # x, mu: (B, F, T); mask: (B, 1, T); t: (B,); spk: (B, spk_emb_dim)
        lens = None
        if self.fused_gn:
            # masks are sequence masks, so the frame count recovers each one
            # exactly (summed in f32: bf16 cannot count past 256)
            lens = torch.round(mask[:, 0, :].float().sum(-1)).to(torch.int32)
        temb = self.mlp(timestep_embedding(t, self.dim, self.pe_scale))
        if self.multi_spks:
            s = self.spk_mlp(spk)
            s_map = s[:, :, None].expand(-1, -1, x.shape[-1])
            h = torch.stack([mu, x, s_map], dim=1)  # (B, 3, F, T)
        else:
            h = torch.stack([mu, x], dim=1)

        # (B, 1, 1, T) in h's dtype: 0 and 1 are exact in both, and a bf16
        # mask on f32 maps (train_bf16) would run torch's slower mixed-dtype
        # kernel in every Block
        mask4 = mask[:, None].to(h.dtype)
        hiddens = []
        masks = [mask4]
        lens_by_level = [lens]
        for i, (res1, res2, attn, down) in enumerate(self.downs):
            m, ln = masks[-1], lens_by_level[-1]
            h = res1(h, m, temb, ln)
            h = res2(h, m, temb, ln)
            h = attn(h)
            hiddens.append(h)
            if i < len(self.downs) - 1:
                h = down(h * m)
                masks.append(m[..., ::2])
                # stride 2 keeps positions 0, 2, 4, ...: ceil(len / 2) survive
                lens_by_level.append(None if ln is None else (ln + 1) // 2)

        m, ln = masks[-1], lens_by_level[-1]
        h = self.mid_block1(h, m, temb, ln)
        h = self.mid_attn(h)
        h = self.mid_block2(h, m, temb, ln)

        for res1, res2, attn, up in self.ups:
            m, ln = masks.pop(), lens_by_level.pop()
            h = torch.cat([h, hiddens.pop()], dim=1)
            h = res1(h, m, temb, ln)
            h = res2(h, m, temb, ln)
            h = attn(h)
            h = up(h * m)

        h = self.final_block(h, mask4, lens)
        out = self.final_conv(h * mask4)
        return (out * mask4)[:, 0]  # (B, F, T)

"""GroupNorm with its statistics from a hand-written kernel (kernel K2), NCHW.

Port of the JAX package's ``ops/groupnorm.py``.  There the Pallas TPU
kernel ``_pallas_lane_sums`` reduces the per-channel sum and sum of squares,
and the fold to groups, the normalise and the affine stay in XLA
(``_fast_group_norm``), with the variance as E[x^2] - E[x]^2.  Here the
statistics are the CUDA kernel ``csrc/groupnorm.cu`` (one block per
(batch, channel) run: in NCHW each is contiguous, so the TPU's 128-lane fold
has no counterpart) and the rest is the same torch arithmetic, so the port
computes what the JAX package computes.  :func:`channel_sums_ref` is the
kernel's plain version.

The gradient is the JAX ``custom_vjp``: autograd of the plain two-pass
GroupNorm (:func:`group_norm_ref`, the JAX ``_xla_group_norm``), recomputed
from the saved inputs.  As in the JAX package, no model uses it: the U-Net
norms are ``nn.GroupNorm`` or kernel K1 (``models/unet.py: FusedGroupNorm``
is its only consumer).

What bounds the kernel on an H100: memory, one read of x.
"""

import ctypes

import torch

from facegantts_tpu_torch.ops import kernels

NAME = "channel_sums"


def channel_sums_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain torch: (B, C, F, T) -> (B, 2, C) f32 per-channel (sum, sum of
    squares)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))], dim=1)


def _entry():
    fn = kernels.library("groupnorm").fgt_channel_sums_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
    return fn


def channel_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) sum and sum of squares of NCHW x, (B, 2, C) f32.

    A CPU tensor takes :func:`channel_sums_ref`.  A CUDA tensor launches the
    kernel or raises: x contiguous f32 (B, C, F, T)."""
    if x.device.type == "cpu":
        return channel_sums_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_sums: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"channel_sums: x must be a contiguous float32 (B, C, F, T), got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, c, f, t = x.shape
    if x.numel() == 0 or b * c > 2**31 - 1:
        raise ValueError(f"channel_sums: unsupported shape {tuple(x.shape)}")
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), out.data_ptr(), b, c, f * t, stream)
    if err != 0:
        raise RuntimeError(f"channel_sums: CUDA kernel launch failed (cudaError {err})")
    kernels.LAUNCHES[NAME] += 1
    return out


def group_norm_ref(x, scale, bias, num_groups: int, eps: float):
    """Plain two-pass GroupNorm (the JAX ``_xla_group_norm``): biased
    variance over (C/G, F, T) per (B, G), per-channel affine."""
    b, c, f, t = x.shape
    xg = x.float().reshape(b, num_groups, c // num_groups, f, t)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, f, t)
    return (xn * scale[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)


def _fast_group_norm(x, scale, bias, num_groups: int, eps: float):
    """GroupNorm from :func:`channel_sums` (the JAX ``_fast_group_norm``)."""
    b, c, f, t = x.shape
    cg = c // num_groups
    per_group = channel_sums(x).reshape(b, 2, num_groups, cg).sum(-1)  # (B, 2, G)
    n = f * t * cg
    mean_g = per_group[:, 0] / n
    var_g = per_group[:, 1] / n - mean_g.square()
    inv = torch.rsqrt(var_g + eps)
    # per-channel affine folded with the group stats: y = x * a + bb
    mean_c = mean_g.repeat_interleave(cg, dim=1)  # (B, C)
    inv_c = inv.repeat_interleave(cg, dim=1)
    a = inv_c * scale[None, :]
    bb = bias[None, :] - mean_c * a
    return x * a[:, :, None, None].to(x.dtype) + bb[:, :, None, None].to(x.dtype)


class _GroupNorm(torch.autograd.Function):
    """Statistics from the kernel; backward = autograd of the plain
    GroupNorm, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _fast_group_norm(x, scale, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        grads = kernels.recompute_vjp(group_norm_ref, ctx.saved_tensors,
                                      ctx.needs_input_grad[:3], g, ctx.num_groups, ctx.eps)
        return (*grads, None, None)


def group_norm(x, scale, bias, num_groups: int = 8, eps: float = 1e-6):
    """GroupNorm over NCHW x (B, C, F, T) with a per-channel affine; the
    statistics come from kernel K2 on a CUDA tensor."""
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, scale, bias)):
        return _GroupNorm.apply(x, scale, bias, num_groups, eps)
    return _fast_group_norm(x, scale, bias, num_groups, eps)

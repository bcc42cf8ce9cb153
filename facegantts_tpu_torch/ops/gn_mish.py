"""Fused GroupNorm -> Mish -> time mask (kernel K1), NCHW.

Replaces the Pallas TPU kernel ``facegantts_tpu/ops/gn_mish.py:_fused_chain``
(public entry ``gn_mish_mask``).  On the GPU it is the hand-written CUDA
kernel ``csrc/gn_mish.cu``; :func:`gn_mish_mask_ref` is its plain torch
version, the same math as the JAX package's ``_xla_chain``.

What bounds it on an H100: memory.  It must read x once and write y once,
2 * B*C*F*T * dtype bytes, at ~20 flops an element -- far below the card's
ridge.  In NCHW each (batch, group) is one contiguous slab, so the kernel is
one statistics pass over (slab, chunk) blocks (many blocks per slab, so
batch 1 still fills the SMs; Chan merges in f32) and one elementwise pass
``y = mish((x - mean) * rstd * scale + bias) * (t < lens[b])``, one warp per
row of T frames.  It takes every shape with ``C % G == 0`` in f32 and bf16.
The TPU kernel's lane packing, parity rows and group-indicator matmul exist
only for the TPU's 128-lane layout and have no counterpart here.

The gradient is the JAX package's ``custom_vjp``: the forward launches the
kernel and saves x, scale and bias; the backward recomputes
:func:`gn_mish_mask_ref` from them and takes its autograd (the JAX backward
is ``jax.vjp`` of ``_xla_chain``; there is no backward kernel on either
side).  ``lens`` gets no gradient.
"""

import ctypes

import torch

from facegantts_tpu_torch.ops import kernels

NAME = "gn_mish_mask"

# blocks per launch phase the grid aims for: ~4 resident blocks per SM
_BLOCKS_PER_SM = 4


def mish_f32(x: torch.Tensor) -> torch.Tensor:
    """Rational-exp Mish on f32 (JAX package models/unet.py ``mish``)."""
    u = torch.exp(torch.clamp(x, max=20.0))
    n = u * (u + 2.0)
    return torch.where(x > 20.0, x, x * (n / (n + 2.0)))


def gn_mish_mask_ref(x, scale, bias, lens, num_groups: int = 8, eps: float = 1e-5):
    """Plain torch: mish(GroupNorm(x)) * (t < lens), statistics in f32.

    x: (B, C, F, T); scale/bias: (C,); lens: (B,) integer frame counts.
    GroupNorm statistics cover every frame, the masked tail included; the
    mask applies after Mish (JAX package ``ops/gn_mish.py:_xla_chain``)."""
    b, c, f, t = x.shape
    xg = x.float().reshape(b, num_groups, c // num_groups, f, t)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, f, t)
    y = mish_f32(xn * scale.float()[None, :, None, None]
                 + bias.float()[None, :, None, None])
    pos = torch.arange(t, device=x.device)
    mask = (pos[None, :] < lens.to(x.device)[:, None]).float()
    return (y * mask[:, None, None, :]).to(x.dtype)


def _entry(dtype: torch.dtype):
    lib = kernels.library("gn_mish")
    fn = lib.fgt_gn_mish_mask_f32 if dtype == torch.float32 else lib.fgt_gn_mish_mask_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
    return fn


def _grid(b: int, c: int, f: int, t: int, num_groups: int, sms: int):
    """(stats chunks per slab, row blocks per slab) for one launch."""
    slabs = b * num_groups
    target = max(1, -(-_BLOCKS_PER_SM * sms // slabs))
    slab_len = c // num_groups * f * t
    nchunks = max(1, min(target, -(-slab_len // 1024)))  # >= 4 elems/thread
    rows = c // num_groups * f
    row_blocks = max(1, min(target, -(-rows // 8)))  # >= 1 row per warp
    return nchunks, row_blocks


def gn_mish_mask(x, scale, bias, lens, num_groups: int = 8, eps: float = 1e-5):
    """mish(GroupNorm(x; scale, bias)) * (t < lens) over NCHW x (B, C, F, T).

    A CPU tensor takes :func:`gn_mish_mask_ref`.  A CUDA tensor launches the
    kernel or raises: x f32 or bf16 and contiguous, scale/bias (C,) f32,
    lens (B,) int32, all on x's device, C divisible by ``num_groups``."""
    if x.device.type == "cpu":
        return gn_mish_mask_ref(x, scale, bias, lens, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_mish_mask: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"gn_mish_mask: x must be (B, C, F, T), got {tuple(x.shape)}")
    b, c, f, t = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gn_mish_mask: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_mish_mask: x must be contiguous (NCHW)")
    if c % num_groups != 0:
        raise ValueError(f"gn_mish_mask: C={c} is not divisible by {num_groups} groups")
    if x.numel() == 0 or b * num_groups > 65535:
        raise ValueError(f"gn_mish_mask: unsupported shape {tuple(x.shape)}")
    for name, v in (("scale", scale), ("bias", bias)):
        if v.shape != (c,) or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"gn_mish_mask: {name} must be a contiguous ({c},) float32")
    if lens.shape != (b,) or lens.dtype != torch.int32 or not lens.is_contiguous():
        raise ValueError(f"gn_mish_mask: lens must be a contiguous ({b},) int32")
    if any(v.device != x.device for v in (scale, bias, lens)):
        raise ValueError("gn_mish_mask: all inputs must be on x's device")
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, scale, bias)):
        return _GnMishMask.apply(x, scale, bias, lens, num_groups, eps)
    return _launch(x, scale, bias, lens, num_groups, eps)


def _launch(x, scale, bias, lens, num_groups: int, eps: float):
    b, c, f, t = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nchunks, row_blocks = _grid(b, c, f, t, num_groups, sms)
    y = torch.empty_like(x)
    partials = torch.empty(b * num_groups * nchunks * 3, dtype=torch.float32,
                           device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry(x.dtype)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), lens.data_ptr(),
        y.data_ptr(), partials.data_ptr(), b, c, f, t, num_groups, eps,
        nchunks, row_blocks, stream,
    )
    if err != 0:
        raise RuntimeError(f"gn_mish_mask: CUDA kernel launch failed (cudaError {err})")
    kernels.LAUNCHES[NAME] += 1
    return y


class _GnMishMask(torch.autograd.Function):
    """Kernel forward; backward = autograd of the plain chain, recomputed."""

    @staticmethod
    def forward(ctx, x, scale, bias, lens, num_groups, eps):
        ctx.save_for_backward(x, scale, bias, lens)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _launch(x, scale, bias, lens, num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, lens = ctx.saved_tensors
        grads = kernels.recompute_vjp(gn_mish_mask_ref, (x, scale, bias),
                                      ctx.needs_input_grad[:3], g, lens, ctx.num_groups,
                                      ctx.eps)
        return (*grads, None, None, None)

"""Fused GroupNorm -> Mish -> time mask (kernel K1), NCHW, and its backward.

Replaces the Pallas TPU kernel ``facegantts_tpu/ops/gn_mish.py:_fused_chain``
(public entry ``gn_mish_mask``) and the JAX ``custom_vjp`` backward around it
(``_bwd``, ``jax.vjp`` of ``_xla_chain``).  On the GPU both are hand-written
CUDA kernels in ``csrc/gn_mish.cu``; :func:`gn_mish_mask_ref` and
:func:`gn_mish_mask_bwd_ref` are their plain torch versions, the same math as
the JAX package's ``_xla_chain`` and its gradient.

What bounds it on an H100: memory.  The forward must read x once and write y
once, the backward read x and the upstream gradient once and write dx once,
at ~20-30 flops an element -- far below the card's ridge.  In NCHW each
(batch, group) is one contiguous slab, so each kernel is one launch of
thread-block clusters, one cluster per slab: the blocks split the slab's
rows, keep them in shared memory, exchange their partial sums through
distributed shared memory and write the result from shared memory, so x
crosses device memory once (the backward: x and the upstream gradient,
reduced per channel part by part as they land).  A slab too large for the
cluster's shared memory at two blocks an SM streams in tiles, the second
read coming from L2 where it holds it; keeping such a slab whole at one
block an SM measured slower on an H100 (``chip_smoke.py`` phase 11 times
both).  Both take every shape with ``C % G == 0`` in f32 and bf16.  The TPU
kernel's lane packing, parity rows and group-indicator matmul exist only
for the TPU's 128-lane layout and have no counterpart here.

The gradient: the forward saves x, scale, bias, lens and the per-(b, g) mean
and rstd; the backward computes the closed form (``gn_mish_mask_bwd``)::

    dz = g * m * mish'(z),  z = xn * s_c + b_c,  xn = (x - mean) * rstd
    dbias_c = sum dz,  dscale_c = sum dz * xn          (over b, f, t)
    dx = rstd * (dxn - mean_g(dxn) - xn * mean_g(dxn * xn)),  dxn = dz * s_c

with m the time mask.  The statistics cover the masked tail, so dx is not
zero there.  ``lens`` gets no gradient.

For ``torch.export`` the no-grad forward is also the registered operator
``facegantts::gn_mish_mask`` (:func:`gn_mish_mask_op`), which an exported
program holds as one node; the live path launches the kernel directly
(``chip_smoke.py`` phase 16 times a request both ways).
"""

import copy
import ctypes
import math

import torch

from facegantts_tpu_torch.ops import kernels

NAME = "gn_mish_mask"
BWD_NAME = "gn_mish_mask_bwd"
OP_NAME = "facegantts::gn_mish_mask"  # the registered no-grad forward (torch.library)

_MAX_CLUSTER = 16  # blocks per cluster: non-portable above 8 (csrc/gn_mish.cu)
_TILE_BYTES = 112 * 1024  # a block's share of its slab in shared memory: two blocks an SM
_MAX_SMEM = 226 * 1024  # dynamic shared memory a block may ask for (227 KB less static)


def mish_f32(x: torch.Tensor) -> torch.Tensor:
    """Rational-exp Mish on f32 (JAX package models/unet.py ``mish``)."""
    u = torch.exp(torch.clamp(x, max=20.0))
    n = u * (u + 2.0)
    return torch.where(x > 20.0, x, x * (n / (n + 2.0)))


def mish_grad_f32(z: torch.Tensor) -> torch.Tensor:
    """d mish_f32 / dz: 1 above the clamp at 20, else w + z (1 - w^2) sigmoid(z)
    with w = n / (n + 2), written as w + z * 4u(u + 1) / (n + 2)^2."""
    u = torch.exp(torch.clamp(z, max=20.0))
    n = u * (u + 2.0)
    den = n + 2.0
    return torch.where(z > 20.0, torch.ones_like(z), n / den + z * (4.0 * u * (u + 1.0) / (den * den)))


def group_stats(x, num_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """(B, G, 2) f32 mean and rstd of x (B, C, F, T) per (batch, group):
    biased variance over (C/G, F, T), every frame included."""
    b, c, f, t = x.shape
    xg = x.float().reshape(b, num_groups, c // num_groups * f * t)
    mean = xg.mean(dim=2)
    var = (xg - mean[..., None]).square().mean(dim=2)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=-1)


def _normalized(x, stats, num_groups: int):
    b, c, f, t = x.shape
    xg = x.float().reshape(b, num_groups, c // num_groups, f, t)
    mean, rstd = (stats[..., i][:, :, None, None, None] for i in (0, 1))
    return ((xg - mean) * rstd).reshape(b, c, f, t)


def _time_mask(lens, t: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device)
    return (pos[None, :] < lens.to(device)[:, None]).float()[:, None, None, :]


def _forward_ref(x, scale, bias, lens, num_groups: int, eps: float):
    stats = group_stats(x, num_groups, eps)
    xn = _normalized(x, stats, num_groups)
    y = mish_f32(xn * scale.float()[None, :, None, None] + bias.float()[None, :, None, None])
    return (y * _time_mask(lens, x.shape[3], x.device)).to(x.dtype), stats


def gn_mish_mask_ref(x, scale, bias, lens, num_groups: int = 8, eps: float = 1e-5):
    """Plain torch: mish(GroupNorm(x)) * (t < lens), statistics in f32.

    x: (B, C, F, T); scale/bias: (C,); lens: (B,) integer frame counts.
    GroupNorm statistics cover every frame, the masked tail included; the
    mask applies after Mish (JAX package ``ops/gn_mish.py:_xla_chain``)."""
    return _forward_ref(x, scale, bias, lens, num_groups, eps)[0]


def gn_mish_mask_bwd_ref(g, x, scale, bias, lens, stats, num_groups: int = 8):
    """Plain torch backward of :func:`gn_mish_mask_ref` in closed form, given
    the upstream gradient g (x's shape) and the forward's (B, G, 2) ``stats``.
    Returns (dx in x's dtype, dscale f32, dbias f32)."""
    b, c, f, t = x.shape
    s = scale.float()[None, :, None, None]
    xn = _normalized(x, stats, num_groups)
    dz = g.float() * _time_mask(lens, t, x.device) * mish_grad_f32(xn * s + bias.float()[None, :, None, None])
    dbias, dscale = dz.sum(dim=(0, 2, 3)), (dz * xn).sum(dim=(0, 2, 3))
    dxn = (dz * s).reshape(b, num_groups, -1)
    xng = xn.reshape(b, num_groups, -1)
    rstd = stats[..., 1][..., None]
    dx = rstd * (dxn - dxn.mean(dim=2, keepdim=True) - xng * (dxn * xng).mean(dim=2, keepdim=True))
    return dx.reshape(b, c, f, t).to(x.dtype), dscale, dbias


# --- the CUDA route ----------------------------------------------------------

_sms = {}  # device -> SM count, once its kernel attributes are set
_plans = {}  # (shape, groups, dtype, backward, device) -> launch plan


def _lib():
    lib = kernels.library("gn_mish")
    if lib.fgt_gn_mish_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fgt_gn_mish_setup.argtypes = [i]
        lib.fgt_gn_mish_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.fgt_gn_mish_fwd.argtypes = [p] * 7 + [ctypes.c_float, p]
        lib.fgt_gn_mish_bwd.argtypes = [p] * 10
        for fn in (lib.fgt_gn_mish_setup, lib.fgt_gn_mish_max_clusters, lib.fgt_gn_mish_fwd,
                   lib.fgt_gn_mish_bwd):
            fn.restype = i
    return lib


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"gn_mish_mask: {what} failed (cudaError {err})")


class _Plan:
    """One shape's launch: 16-byte copies or not (vec), blocks per cluster,
    rows per block (rpb), rows per shared-memory tile (rpt), dynamic shared
    bytes, how many such clusters the card holds at once (active), and
    ``args``, the same 11 ints as csrc/gn_mish.cu's ``Plan`` in a ctypes
    array passed by pointer (one argument instead of eleven)."""

    __slots__ = ("vec", "cluster", "rpb", "rpt", "smem", "active", "args")

    def __init__(self, shape, num_groups, bf16, vec, cluster, rpb, rpt, smem, active):
        b, c, f, t = shape
        self.vec, self.cluster, self.rpb, self.rpt, self.smem = vec, cluster, rpb, rpt, smem
        self.active = active
        self.args = (ctypes.c_int * 11)(bf16, vec, b, num_groups, c // num_groups, f, t, cluster,
                                        rpb, rpt, smem)

    def plain_copies(self):
        """The same plan with element copies (for a view at an odd offset)."""
        other = copy.copy(self)
        other.vec = 0
        other.args = (ctypes.c_int * 11)(*self.args)
        other.args[1] = 0
        return other


_BWD_PARTS = 2  # the backward's load parts a tile (csrc/gn_mish.cu kBwdParts)
_WARPS = 16  # warps a block (csrc/gn_mish.cu kWarps)


def _smem_bytes(shape, num_groups: int, elem: int, bwd: bool, rpb: int, rpt: int) -> int:
    """Dynamic shared memory of a block (csrc/gn_mish.cu's layout): the
    tiles (x, and g backward, each rounded to 16 bytes), each row's two
    coefficients (floats) and, backward, the block's channel sums and a
    tile's slice partials, one slice a warp a part (a float2 each)."""
    _, c, f, t = shape
    cg = c // num_groups
    smem = (2 if bwd else 1) * (-(-rpt * t * elem // 16) * 16) + 8 * rpt
    if bwd:
        smem += 8 * (min(cg, rpb // f + 2) + min(cg, rpt // f + 2) + _BWD_PARTS * _WARPS)
    return smem


def _make_plan(lib, shape, num_groups: int, elem: int, bwd: bool, sms: int) -> _Plan:
    """A cluster of up to 16 blocks per (b, g) slab, enough blocks to fill
    the card twice and each block's rows within _TILE_BYTES; beyond that
    the rows stream in tiles.  16-byte bulk copies where the slab and every
    block's and tile's first row are 16-byte aligned (and rows hold at least
    one 16-byte vector)."""
    b, c, f, t = shape
    cg = c // num_groups
    rows, slabs, nbuf = cg * f, b * num_groups, 2 if bwd else 1
    per_vec = 16 // elem
    vec = int(rows * t % per_vec == 0 and t >= per_vec)
    q = per_vec // math.gcd(t, per_vec) if vec else 1  # row granularity of a 16-byte start
    row_bytes = t * elem * nbuf
    cluster = 1
    while cluster < _MAX_CLUSTER and rows >= 2 * cluster * q and (
            slabs * cluster < 2 * sms or rows * row_bytes > cluster * _TILE_BYTES):
        cluster *= 2
    kind = 4 * bwd + 2 * (elem == 2) + vec
    while True:
        rpb = -(-rows // cluster)
        rpb = -(-rpb // q) * q
        rpt = min(rpb, max(q, _TILE_BYTES // row_bytes // q * q))
        smem = _smem_bytes(shape, num_groups, elem, bwd, rpb, rpt)
        if smem > _MAX_SMEM:
            raise ValueError(f"gn_mish_mask: unsupported shape {tuple(shape)}")
        fits = ctypes.c_int(0)
        _check(lib.fgt_gn_mish_max_clusters(kind, cluster, smem, ctypes.byref(fits)),
               "occupancy query")
        if fits.value > 0 or cluster == 1:
            return _Plan(shape, num_groups, int(elem == 2), vec, cluster, rpb, rpt, smem,
                         fits.value)
        cluster //= 2


def _plan(x, num_groups: int, bwd: bool) -> _Plan:
    key = (tuple(x.shape), num_groups, x.dtype, bwd, x.device)
    plan = _plans.get(key)
    if plan is None:
        lib = _lib()
        dev = x.device
        if dev not in _sms:
            with torch.cuda.device(dev):
                _check(lib.fgt_gn_mish_setup(_MAX_SMEM), "kernel set-up")
            _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.cuda.device(dev):
            plan = _plans[key] = _make_plan(lib, x.shape, num_groups, x.element_size(), bwd,
                                            _sms[dev])
    if plan.vec and x.data_ptr() % 16:  # a view at an odd offset: element copies
        return plan.plain_copies()
    return plan


def _check_inputs(x, scale, bias, lens, num_groups: int):
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
    if not (scale.device == bias.device == lens.device == x.device):
        raise ValueError("gn_mish_mask: all inputs must be on x's device")


def gn_mish_mask(x, scale, bias, lens, num_groups: int = 8, eps: float = 1e-5):
    """mish(GroupNorm(x; scale, bias)) * (t < lens) over NCHW x (B, C, F, T).

    A CPU tensor takes :func:`gn_mish_mask_ref` (and, where a gradient is
    needed, :func:`gn_mish_mask_bwd_ref` through the same autograd Function
    as the GPU).  A CUDA tensor launches the kernels or raises: x f32 or
    bf16 and contiguous, scale/bias (C,) f32, lens (B,) int32, all on x's
    device, C divisible by ``num_groups``."""
    if x.device.type != "cpu":
        _check_inputs(x, scale, bias, lens, num_groups)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GnMishMask.apply(x, scale, bias, lens, num_groups, eps)
    if torch.compiler.is_exporting():  # an exported program holds the op, not its body
        return gn_mish_mask_op(x, scale, bias, lens, num_groups, eps)
    if x.device.type == "cpu":
        return gn_mish_mask_ref(x, scale, bias, lens, num_groups, eps)
    return _launch_fwd(x, scale, bias, lens, num_groups, eps, False)[0]


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cuda")
def gn_mish_mask_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    lens: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    """K1's no-grad forward as the registered operator ``facegantts::gn_mish_mask``,
    which ``torch.export`` keeps as one node: on a CUDA tensor the kernel
    launch, on a CPU tensor :func:`gn_mish_mask_ref`.  No autograd is
    registered; the gradient path is :class:`_GnMishMask`.  A program that
    holds the op needs this module imported before ``torch.export.load``."""
    _check_inputs(x, scale, bias, lens, num_groups)
    return _launch_fwd(x, scale, bias, lens, num_groups, eps, False)[0]


@gn_mish_mask_op.register_kernel("cpu")
def _gn_mish_mask_op_cpu(x, scale, bias, lens, num_groups, eps):
    return gn_mish_mask_ref(x, scale, bias, lens, num_groups, eps)


@gn_mish_mask_op.register_fake
def _gn_mish_mask_op_fake(x, scale, bias, lens, num_groups, eps):
    return torch.empty_like(x)


def _launch_fwd(x, scale, bias, lens, num_groups: int, eps: float, keep_stats: bool):
    """y and, if keep_stats, the (B, G, 2) mean and rstd (else None)."""
    plan = _plan(x, num_groups, False)
    y = torch.empty_like(x)
    stats = (torch.empty((x.shape[0], num_groups, 2), dtype=torch.float32, device=x.device)
             if keep_stats else None)
    err = _lib().fgt_gn_mish_fwd(
        plan.args, x.data_ptr(), scale.data_ptr(), bias.data_ptr(), lens.data_ptr(),
        y.data_ptr(), stats.data_ptr() if keep_stats else None, eps, _stream(x))
    _check(err, "forward kernel launch")
    kernels.LAUNCHES[NAME] += 1
    return y, stats


def _stream(x) -> int:
    """The raw handle of the current CUDA stream of x's device."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def gn_mish_mask_bwd(g, x, scale, bias, lens, stats, num_groups: int = 8):
    """Backward of :func:`gn_mish_mask`: (dx, dscale, dbias) from the upstream
    gradient g and the forward's (B, G, 2) mean and rstd.  A CPU tensor takes
    :func:`gn_mish_mask_bwd_ref`; a CUDA tensor launches the backward kernel
    or raises."""
    if x.device.type == "cpu":
        return gn_mish_mask_bwd_ref(g, x, scale, bias, lens, stats, num_groups)
    _check_inputs(x, scale, bias, lens, num_groups)
    b, c = x.shape[:2]
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or g.device != x.device:
        raise ValueError("gn_mish_mask_bwd: g must be contiguous, of x's shape, type and device")
    if (stats.shape != (b, num_groups, 2) or stats.dtype != torch.float32
            or not stats.is_contiguous() or stats.device != x.device):
        raise ValueError(f"gn_mish_mask_bwd: stats must be a contiguous ({b}, {num_groups}, 2) "
                         "float32 on x's device")
    plan = _plan(x, num_groups, True)
    if plan.vec and g.data_ptr() % 16:
        plan = plan.plain_copies()
    dx = torch.empty_like(x)
    dparams = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    err = _lib().fgt_gn_mish_bwd(
        plan.args, x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        lens.data_ptr(), stats.data_ptr(), dx.data_ptr(), dparams.data_ptr(), _stream(x))
    _check(err, "backward kernel launch")
    kernels.LAUNCHES[BWD_NAME] += 1
    dbias, dscale = dparams.sum(dim=0).unbind(dim=1)
    return dx, dscale, dbias


class _GnMishMask(torch.autograd.Function):
    """Kernel forward (saves x, scale, bias, lens, mean and rstd); kernel
    backward.  On the CPU the same Function runs the plain versions."""

    @staticmethod
    def forward(ctx, x, scale, bias, lens, num_groups, eps):
        if x.device.type == "cpu":
            y, stats = _forward_ref(x, scale, bias, lens, num_groups, eps)
        else:
            y, stats = _launch_fwd(x, scale, bias, lens, num_groups, eps, True)
        ctx.save_for_backward(x, scale, bias, lens, stats)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, lens, stats = ctx.saved_tensors
        grads = gn_mish_mask_bwd(g.contiguous(), x, scale, bias, lens, stats, ctx.num_groups)
        return (*(v if n else None for v, n in zip(grads, ctx.needs_input_grad[:3])),
                None, None, None)

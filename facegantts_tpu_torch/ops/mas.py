"""Monotonic alignment search (MAS), in torch and as a CUDA kernel.

Port of the JAX package's ``ops/mas.py:maximum_path`` (a ``lax.scan`` there,
not a Pallas kernel; the reference runs a Cython kernel on the host).  The
Viterbi DP has a strict column-to-column dependency, so a faithful torch
transcription is a Python loop of several launches per mel column --
thousands per training step.  On the GPU it is therefore the hand-written
kernel ``csrc/mas.cu``: a cluster of two blocks per batch item.  In the
first, up to eight DP warps walk the columns with the text rows in
registers (no block barrier a column) while the other warps stage the band
of value and mask into a ring of shared-memory tiles; the second zeroes the
output.  Every backtrack decision is one bit in shared memory, and after
the backtrack only the path cells are written; nothing returns to the host.
:func:`maximum_path_ref` is its plain version, the JAX wavefront op for op
in f32, so both give the JAX package's path exactly: masked values zeroed,
lengths from the mask sums (at least 1), the band outside written as -1e9,
and the backtrack's tie-break ``index == y or v_same < v_diag``.

What bounds the kernel on an H100: the bytes (value and mask read inside
the feasibility band ``max(0, tx + y - ty) <= x <= min(tx - 1, y)``, the
only cells the path depends on; the path written whole) and the T_y
dependent column steps of one item, which at the training shapes take
longer than the bytes (``csrc/mas.cu``'s header).
"""

import ctypes

import torch

from facegantts_tpu_torch.ops import kernels

NAME = "maximum_path"
_NEG = -1e9
_STAGES = 3  # tiles in the ring (csrc/mas.cu kStages)
# mbarriers, the sum scratch, the DP warps' progress counters and boundary
# rings (csrc/mas.cu kHeader)
_HEADER = 2 * _STAGES * 8 + 32 * 4 + 8 * 4 + 7 * 64 * 4
_MAX_SMEM = 232448  # H100: dynamic shared memory one block may use


def maximum_path_ref(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain torch: the JAX package's wavefront MAS, one column at a time.

    value, mask: (B, T_x, T_y).  Returns the (B, T_x, T_y) 0/1 path times
    the mask, in value's dtype."""
    dtype = value.dtype
    value = value.float()
    maskf = mask.float()
    b, t_x, t_y = value.shape
    dev = value.device
    tx = torch.clamp(maskf[:, :, 0].sum(-1).to(torch.int32), min=1)  # (B,)
    ty = torch.clamp(maskf[:, 0, :].sum(-1).to(torch.int32), min=1)
    x_idx = torch.arange(t_x, dtype=torch.int32, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)

    value = torch.where(maskf > 0, value, torch.zeros((), device=dev))
    v_prev = torch.full((b, t_x), _NEG, dtype=torch.float32, device=dev)
    vals = []
    for y in range(t_y):
        same = torch.where(x_idx[None, :] == y, neg, v_prev)
        head = torch.full((b, 1), 0.0 if y == 0 else _NEG, dtype=torch.float32, device=dev)
        diag = torch.cat([head, v_prev[:, :-1]], dim=1)
        v = value[:, :, y] + torch.maximum(same, diag)
        lo = torch.clamp(tx + y - ty, min=0)
        hi = torch.clamp(tx - 1, max=y)
        valid = (x_idx[None, :] >= lo[:, None]) & (x_idx[None, :] <= hi[:, None])
        v_prev = torch.where(valid, v, neg)
        vals.append(v_prev)

    rows = torch.arange(b, device=dev)
    index = (tx - 1).long()
    path = torch.zeros((b, t_x, t_y), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        active = y < ty
        path[rows, index, y] = active.float()
        if y == 0:
            break
        vprev = vals[y - 1]
        v_same = vprev[rows, index]
        v_diag = vprev[rows, torch.clamp(index - 1, min=0)]
        down = active & (index != 0) & ((index == y) | (v_same < v_diag))
        index = index - down.long()
    return (path * maskf).to(dtype)


# fgt_mas_f32(value, mask, path, B, T_x, T_y, R, W, smem, vec, stream)
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_entry = None  # the C entry, resolved at the first launch


def _resolve():
    global _entry
    _entry = kernels.entry("mas", "fgt_mas_f32", _ARGTYPES)
    return _entry


def _col_stride(rows_per_lane: int) -> int:
    """Floats between two columns of a staged tile (csrc/mas.cu col_stride)."""
    return (33 * rows_per_lane - 1 + 31) // 32 * 32 + 1


def _launch_config(t_x: int, t_y: int):
    """(rows per lane R, mel columns a tile W, dynamic shared bytes) of one
    launch, or None where no tile width fits one block's shared memory.

    The DP warps keep R = T_x / 32 rounded up to a power of two rows a lane
    (over up to eight warps); a ring of _STAGES tiles of W columns (the
    widest of 32, 16, 8 that fits), a 32-bit word of decision bits per row
    slot (R a lane) and column, and the T_y path rows share the block's
    memory with the header (csrc/mas.cu's layout)."""
    r = 1
    while 32 * r < t_x:
        r *= 2
    for w in (32, 16, 8):
        smem = _HEADER + 4 * _STAGES * w * _col_stride(r) + 4 * t_y * r + 4 * t_y
        if smem <= _MAX_SMEM:
            return r, w, smem
    return None


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max-likelihood monotonic alignment path of a (B, T_x, T_y) log-prior.

    Any floating ``value`` and ``mask``: both are upcast to f32, as the JAX
    package's ``maximum_path`` does, and the path returns in value's dtype.
    A CPU tensor takes :func:`maximum_path_ref`.  A CUDA tensor launches the
    kernel or raises: value and mask floating tensors of one shape on one
    device, T_x <= 1024, and the shared memory of one block enough for the
    (T_x, T_y) decision bits."""
    if value.device.type == "cpu":
        return maximum_path_ref(value, mask)
    if value.device.type != "cuda":
        raise ValueError(f"maximum_path: unsupported device {value.device}")
    if value.dim() != 3 or mask.shape != value.shape:
        raise ValueError(f"maximum_path: value and mask must be one (B, T_x, T_y) shape, "
                         f"got {tuple(value.shape)} and {tuple(mask.shape)}")
    for name, v in (("value", value), ("mask", mask)):
        if not v.is_floating_point() or v.device != value.device:
            raise ValueError(f"maximum_path: {name} must be a floating tensor "
                             f"on {value.device}")
    dtype = value.dtype
    value, mask = value.float().contiguous(), mask.float().contiguous()
    b, t_x, t_y = value.shape
    if value.numel() == 0 or t_x > 1024 or b > 2**30:
        raise ValueError(f"maximum_path: unsupported shape {tuple(value.shape)}")
    config = _launch_config(t_x, t_y)
    if config is None:
        raise ValueError(f"maximum_path: T_x={t_x}, T_y={t_y} needs more shared memory than "
                         f"one block has ({_MAX_SMEM} bytes)")
    path = torch.empty_like(value)
    vp, mp = value.data_ptr(), mask.data_ptr()
    vec = int(t_y % 4 == 0 and vp % 16 == 0 and mp % 16 == 0)
    err = (_entry or _resolve())(vp, mp, path.data_ptr(), b, t_x, t_y, *config, vec,
                                 torch._C._cuda_getCurrentRawStream(value.device.index))
    if err != 0:
        raise RuntimeError(f"maximum_path: CUDA kernel launch failed (cudaError {err})")
    kernels.LAUNCHES[NAME] += 1
    return path.to(dtype)

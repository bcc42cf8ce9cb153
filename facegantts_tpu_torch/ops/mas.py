"""Monotonic alignment search (MAS), in torch and as a CUDA kernel.

Port of the JAX package's ``ops/mas.py:maximum_path`` (a ``lax.scan`` there,
not a Pallas kernel; the reference runs a Cython kernel on the host).  The
Viterbi DP has a strict column-to-column dependency, so a faithful torch
transcription is a Python loop of several launches per mel column --
thousands per training step.  On the GPU it is therefore the hand-written
kernel ``csrc/mas.cu``: one block per batch item walks the columns with the
previous column in shared memory, keeps every backtrack decision as one bit
in shared memory and writes the path; nothing returns to the host.
:func:`maximum_path_ref` is its plain version, the JAX wavefront op for op
in f32, so both give the JAX package's path exactly: masked values zeroed,
lengths from the mask sums (at least 1), the band outside written as -1e9,
and the backtrack's tie-break ``index == y or v_same < v_diag``.

What bounds the kernel on an H100: the bytes (value and mask read inside
the feasibility band ``max(0, tx + y - ty) <= x <= min(tx - 1, y)``, the
only cells the path depends on; the path written whole) and, below them,
the T_y dependent column steps.
"""

import ctypes

import torch

from facegantts_tpu_torch.ops import kernels

NAME = "maximum_path"
_NEG = -1e9
_TILE = 32  # mel columns per shared-memory tile (csrc/mas.cu kTile)
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


def _entry():
    fn = kernels.library("mas").fgt_mas_f32
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return fn


def _launch_config(t_x: int, t_y: int):
    """(threads per block, dynamic shared-memory bytes) of one launch."""
    threads = max(32, -(-t_x // 32) * 32)
    smem = 4 * (_TILE * (threads + 1) + 2 * threads + 32 + t_y * (threads // 32) + t_y)
    return threads, smem


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max-likelihood monotonic alignment path of a (B, T_x, T_y) log-prior.

    A CPU tensor takes :func:`maximum_path_ref`.  A CUDA tensor launches the
    kernel or raises: value and mask contiguous f32 of one shape on one
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
        if v.dtype != torch.float32 or not v.is_contiguous() or v.device != value.device:
            raise ValueError(f"maximum_path: {name} must be a contiguous float32 tensor "
                             f"on {value.device}")
    b, t_x, t_y = value.shape
    if value.numel() == 0 or t_x > 1024 or b > 2**31 - 1:
        raise ValueError(f"maximum_path: unsupported shape {tuple(value.shape)}")
    threads, smem = _launch_config(t_x, t_y)
    if smem > _MAX_SMEM:
        raise ValueError(f"maximum_path: T_x={t_x}, T_y={t_y} needs {smem} bytes of shared "
                         f"memory, more than one block has ({_MAX_SMEM})")
    path = torch.empty_like(value)
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = _entry()(value.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_x, t_y,
                   threads, smem, stream)
    if err != 0:
        raise RuntimeError(f"maximum_path: CUDA kernel launch failed (cudaError {err})")
    kernels.LAUNCHES[NAME] += 1
    return path

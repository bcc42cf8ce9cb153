"""Alignment / masking utilities (reference model/utils.py:6-45), in torch.

Same math and layouts as the JAX package's ``ops/align.py``; the float
cumulative sum in :func:`generate_path` and the float length sums upstream
are kept in the caller's dtype so the frame boundaries land where the JAX
package puts them.
"""

import math

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool mask (reference model/utils.py:6-11)."""
    pos = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 2) -> int:
    """Round up to a multiple of 2**levels for the U-Net (model/utils.py:14-18)."""
    factor = 2**num_downsamplings_in_unet
    return int(math.ceil(length / factor) * factor)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Durations -> hard monotonic alignment path (model/utils.py:27-40).

    duration: (B, T_x) non-negative; mask: (B, T_x, T_y).
    Returns (B, T_x, T_y) 0/1 path where row x covers mel frames
    [cumsum[x-1], cumsum[x])."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration, dim=1)  # (B, T_x)
    pos = torch.arange(t_y, dtype=cum.dtype, device=cum.device)
    upper = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    lower = torch.nn.functional.pad(upper, (0, 0, 1, 0))[:, :-1]
    return (upper - lower) * mask


def duration_loss(logw: torch.Tensor, logw_: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """MSE in the log-duration domain, normalised by the total text length
    (model/utils.py:43-45)."""
    return torch.sum((logw - logw_) ** 2) / torch.sum(lengths)

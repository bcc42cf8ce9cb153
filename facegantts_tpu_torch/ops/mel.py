"""Mel-spectrogram op of the PyTorch port.

Port of the JAX package's ``ops/mel.py``, the HiFi-GAN-convention extraction
of the reference (utils/mel_spectrogram.py:48-93): reflect-pad by
(n_fft-hop)/2, non-centred Hann frames, magnitude with a 1e-9 floor inside
the sqrt, Slaney-normalised mel filterbank, log with a 1e-5 clamp.

As in the JAX package, the STFT is framing and one matmul with the windowed
[cos; sin] DFT basis, and the mel projection a second matmul: plain
``torch.matmul``, no kernel of the port (the JAX op computes outside any
Pallas kernel).  Both matmuls run in strict f32 on the card: TF32 is off
for them whatever the process sets, as TF32's 10-bit mantissa would move
the near-empty bins of a tone far more than f32 rounding does.  The
filterbank and the basis are the JAX package's numpy constructions.
"""

import contextlib
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel_slaney(f):
    """Slaney-style mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney mel filterbank with Slaney area normalization, shape (n_mels, n_fft//2+1).

    Matches librosa.filters.mel(..., htk=False, norm='slaney') which the
    reference uses (utils/mel_spectrogram.py:58)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_basis(n_fft: int, win_len: int) -> np.ndarray:
    """Windowed real-DFT basis, shape (n_fft, 2*(n_fft//2+1)).

    frames @ basis == [Re(rfft(frame*win)); Im(rfft(frame*win))] concatenated.
    The periodic Hann window is baked into the basis (one matmul total)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    # periodic hann, centered in the FFT buffer like torch.stft for win<n_fft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_len) / win_len)
    pad = (n_fft - win_len) // 2
    full_win = np.zeros(n_fft)
    full_win[pad : pad + win_len] = win
    basis = np.concatenate([np.cos(ang), np.sin(ang)], axis=1) * full_win[:, None]
    return basis.astype(np.float32)


# (device, constructor, arguments) -> the constant as an f32 tensor there
_consts: Dict[Tuple, torch.Tensor] = {}


def _on(device: torch.device, fn, *args) -> torch.Tensor:
    key = (str(device), fn.__name__, args)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.as_tensor(fn(*args), device=device)
    return t


@contextlib.contextmanager
def _strict_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(y, ((0, 0), (pad, pad)), mode="reflect")`` of (B, T): the
    reflection repeats where ``pad`` reaches past the signal (a clip shorter
    than the pad), which ``F.pad`` refuses."""
    t = y.shape[-1]
    if pad < t:
        return F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    period = 2 * (t - 1)
    i = torch.arange(-pad, t + pad, device=y.device) % period
    return y[:, torch.where(i < t, i, period - i)]


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Slice (B, T) into non-centered frames (B, n_frames, n_fft)."""
    return y.unfold(-1, n_fft, hop)


def mel_spectrogram(
    y,
    n_fft: int = 1024,
    num_mels: int = 128,
    sampling_rate: int = 16000,
    hop_size: int = 160,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    center: bool = False,
) -> torch.Tensor:
    """(B, T) float waveform in [-1, 1] (a tensor, or numpy for the CPU)
    -> (B, num_mels, n_frames) f32 log-mel on the waveform's device.

    Frame count matches torch.stft(center=False) after the reference's
    (n_fft-hop)/2 reflect pad: n_frames = 1 + T // hop - n_fft // hop."""
    y = torch.as_tensor(y, dtype=torch.float32)
    if y.ndim == 1:
        y = y[None]
    assert not center, "reference uses center=False with explicit reflect pad"
    pad = (n_fft - hop_size) // 2
    y = reflect_pad(y, pad)

    frames = frame_signal(y, n_fft, hop_size)  # (B, F, n_fft)
    n_bins = n_fft // 2 + 1
    with _strict_f32_matmul():
        spec = torch.matmul(frames, _on(y.device, _dft_basis, n_fft, win_size))  # (B, F, 2*bins)
        power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
        mag = torch.sqrt(power + 1e-9)  # reference's in-sqrt floor
        fb = _on(y.device, mel_filterbank, sampling_rate, n_fft, num_mels, fmin, fmax)
        mel = torch.matmul(fb, mag.transpose(1, 2))  # (B, num_mels, F)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram_float64(y, n_fft: int = 1024, num_mels: int = 128,
                            sampling_rate: int = 16000, hop_size: int = 160,
                            win_size: int = 1024, fmin: float = 0.0,
                            fmax: float = 8000.0) -> np.ndarray:
    """:func:`mel_spectrogram`'s formula in float64 numpy, from the exact
    window and DFT (the filterbank is the op's own): the reference that the
    op is held to on the card and in the tests.  (B, T) -> (B, num_mels,
    n_frames)."""
    pad = (n_fft - hop_size) // 2
    y = np.pad(np.atleast_2d(np.asarray(y, np.float64)), ((0, 0), (pad, pad)), mode="reflect")
    n = 1 + (y.shape[1] - n_fft) // hop_size
    frames = y[:, np.arange(n_fft)[None] + hop_size * np.arange(n)[:, None]]
    ang = -2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None] / n_fft
    win = np.zeros(n_fft)
    lo = (n_fft - win_size) // 2
    win[lo:lo + win_size] = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_size) / win_size)
    re, im = frames @ (np.cos(ang) * win[:, None]), frames @ (np.sin(ang) * win[:, None])
    fb = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax).astype(np.float64)
    mel = np.einsum("bfk,mk->bmf", np.sqrt(re ** 2 + im ** 2 + 1e-9), fb)
    return np.log(np.maximum(mel, 1e-5))


def num_mel_frames(n_samples: int, n_fft: int = 1024, hop: int = 160) -> int:
    """Frame count produced by mel_spectrogram for a T-sample input."""
    pad = (n_fft - hop) // 2
    return 1 + (n_samples + 2 * pad - n_fft) // hop

"""Stationary spectral-gating denoiser.

A copy of the JAX package's module of the same name: the port imports
nothing of that package, so it keeps its own.

Capability equivalent of the reference's ``noisereduce.reduce_noise(...,
stationary=True, prop_decrease=f, n_fft=1024, win_length=1024,
hop_length=160)`` preprocessing step (reference data/lrs2_dataset.py:73-84),
implemented natively and step-for-step after noisereduce v2's
``SpectralGateStationary``:

  1. centered Hann STFT of the clip,
  2. magnitudes to dB with the package's ``amplitude_to_db`` semantics
     (20*log10 with amin floor, then a top_db=80 clamp below the global max),
  3. per-frequency stationary noise threshold = mean + n_std_thresh * std of
     the dB spectrogram over time (noise statistics come from the signal
     itself when no explicit noise clip is given — the reference gives none),
  4. binary mask (signal above threshold) smoothed by a normalized
     triangular outer-product filter whose extents derive from
     freq_mask_smooth_hz / time_mask_smooth_ms (package defaults 500 Hz /
     50 ms),
  5. mask mixed toward unity by ``prop_decrease`` in the LINEAR domain and
     multiplied into the complex STFT, then inverse-STFT overlap-add.

Runs offline on the host (numpy) during dataset packing — never in the
training hot path.  ``tests/test_torch_data.py`` holds it to the JAX
package's copy.
"""

import numpy as np


def _hann(n):
    # periodic Hann, matching scipy.signal.get_window("hann", n, fftbins=True)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _stft_centered(y, n_fft, hop, win_length):
    """Centered STFT -> (n_freq, n_frames) complex, librosa conventions."""
    win = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    win[off : off + win_length] = _hann(win_length)
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win
    return np.fft.rfft(frames, axis=-1).T, win


def _istft_centered(spec, n_samples, n_fft, hop, win):
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * win
    n_frames = frames.shape[0]
    out = np.zeros((n_frames - 1) * hop + n_fft)
    norm = np.zeros_like(out)
    w2 = win**2
    for i in range(n_frames):
        out[i * hop : i * hop + n_fft] += frames[i]
        norm[i * hop : i * hop + n_fft] += w2
    out = out / np.maximum(norm, 1e-10)
    pad = n_fft // 2
    return out[pad : pad + n_samples]


def _amp_to_db(x, amin=1e-20, top_db=80.0):
    """librosa.amplitude_to_db(ref=1.0) as used by noisereduce: global
    top_db clamp below the array maximum."""
    db = 20.0 * np.log10(np.maximum(amin, x))
    return np.maximum(db, db.max() - top_db)


def _smoothing_filter(n_grad_freq, n_grad_time):
    """noisereduce's normalized triangular outer-product mask smoother."""
    f = np.concatenate(
        [np.linspace(0, 1, n_grad_freq + 1, endpoint=False),
         np.linspace(1, 0, n_grad_freq + 2)]
    )[1:-1]
    t = np.concatenate(
        [np.linspace(0, 1, n_grad_time + 1, endpoint=False),
         np.linspace(1, 0, n_grad_time + 2)]
    )[1:-1]
    filt = np.outer(f, t)
    return filt / filt.sum()


def _conv2_same(x, k):
    """2-D 'same' convolution via FFT (scipy.signal.fftconvolve semantics)."""
    fy, fx = k.shape
    out_shape = (x.shape[0] + fy - 1, x.shape[1] + fx - 1)
    X = np.fft.rfft2(x, out_shape)
    K = np.fft.rfft2(k, out_shape)
    full = np.fft.irfft2(X * K, out_shape)
    y0, x0 = (fy - 1) // 2, (fx - 1) // 2
    return full[y0 : y0 + x.shape[0], x0 : x0 + x.shape[1]]


def spectral_gate(
    y: np.ndarray,
    sr: int,
    prop_decrease: float = 0.7,
    n_std_thresh: float = 1.5,
    n_fft: int = 1024,
    hop: int = 160,
    win_length: int = None,
    freq_mask_smooth_hz: float = 500.0,
    time_mask_smooth_ms: float = 50.0,
) -> np.ndarray:
    """Denoise a mono float waveform; stationary gate (noise statistics from
    the full clip, exactly the reference's configuration).  Defaults match
    the reference call: its mel-analysis n_fft/win/hop (config.py:33-35)
    plus noisereduce's own stationary-gate defaults."""
    y = np.asarray(y, dtype=np.float64)
    if win_length is None:
        win_length = n_fft
    if len(y) < n_fft:
        return y.astype(np.float32)
    spec, win = _stft_centered(y, n_fft, hop, win_length)  # (freq, time)
    sig_db = _amp_to_db(np.abs(spec))

    noise_thresh = sig_db.mean(axis=1) + n_std_thresh * sig_db.std(axis=1)
    mask = (sig_db > noise_thresh[:, None]).astype(np.float64)

    n_grad_freq = int(freq_mask_smooth_hz / (sr / (n_fft / 2)))
    n_grad_time = int(time_mask_smooth_ms / (hop / sr * 1000.0))
    if not (n_grad_freq == 1 and n_grad_time == 1):
        mask = _conv2_same(mask, _smoothing_filter(n_grad_freq, n_grad_time))
    mask = mask * prop_decrease + (1.0 - prop_decrease)

    out = _istft_centered(spec * mask, len(y), n_fft, hop, win)
    return out.astype(np.float32)


def fade_out(y: np.ndarray, sr: int, duration_s: float = 0.05) -> np.ndarray:
    """Linear fade-out over the final `duration_s` seconds (reference
    lrs2_dataset.py:89-91)."""
    n = min(len(y), int(sr * duration_s))
    if n <= 0:
        return y
    y = np.array(y, copy=True)
    y[-n:] *= np.linspace(1.0, 0.0, n, dtype=y.dtype)
    return y

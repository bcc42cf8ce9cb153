"""RBJ-cookbook biquad filters + the reference's adaptive-bandstop analysis.

A copy of the JAX package's module of the same name: the port imports
nothing of that package, so it keeps its own.

The reference's data-filtering experiments (reference
lrs2_preprocessing/data_filtering/filter_test.py:59-98) post-process wavs
with torchaudio biquads: an *adaptive* band-reject placed at the dominant
spectral peak below 300 Hz (filter_test.py:71-82), then optional
highpass/lowpass biquads (filter_test.py:85-98).  The same biquads are the
evaluation band-pass sanity filter (reference acc_measure.py:55-57).

torchaudio.functional.{highpass,lowpass,bandreject}_biquad are exact
RBJ Audio-EQ-Cookbook second-order sections applied as a single-pass
difference equation with the output clamped to [-1, 1]
(torchaudio lfilter clamp=True).  This module reproduces those semantics
on numpy so the preprocessing and evaluation protocols match the
reference bit-for-bit up to float round-off, with no torch dependency on
the data path.
"""

import math
from typing import Optional, Tuple

import numpy as np

#: torchaudio's default biquad Q (1/sqrt(2), Butterworth-like)
DEFAULT_Q = 0.7071067811865476


def rbj_coeffs(kind: str, sr: int, fc: float, q: float = DEFAULT_Q
               ) -> Tuple[np.ndarray, np.ndarray]:
    """RBJ cookbook (b, a) for ``kind`` in {highpass, lowpass, bandreject}.

    Matches torchaudio.functional.{highpass,lowpass,bandreject}_biquad's
    coefficient formulas exactly."""
    w0 = 2.0 * math.pi * fc / sr
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    elif kind == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    elif kind == "bandreject":
        b = np.array([1.0, -2 * cw, 1.0])
    else:
        raise ValueError(f"unknown biquad kind {kind!r}")
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return b, a


def biquad(wav: np.ndarray, b: np.ndarray, a: np.ndarray,
           clamp: bool = True) -> np.ndarray:
    """Single-pass direct-form difference equation (torchaudio lfilter
    semantics: zero initial conditions, optional [-1, 1] output clamp)."""
    from scipy.signal import lfilter

    out = lfilter(b / a[0], a / a[0], np.asarray(wav, np.float64))
    if clamp:
        out = np.clip(out, -1.0, 1.0)
    return out


def highpass_biquad(wav: np.ndarray, sr: int, cutoff: float,
                    q: float = DEFAULT_Q) -> np.ndarray:
    return biquad(wav, *rbj_coeffs("highpass", sr, cutoff, q))


def lowpass_biquad(wav: np.ndarray, sr: int, cutoff: float,
                   q: float = DEFAULT_Q) -> np.ndarray:
    return biquad(wav, *rbj_coeffs("lowpass", sr, cutoff, q))


def bandreject_biquad(wav: np.ndarray, sr: int, center: float,
                      q: float = DEFAULT_Q) -> np.ndarray:
    return biquad(wav, *rbj_coeffs("bandreject", sr, center, q))


def _stft_mag(wav: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """|STFT| with torch.stft conventions (center=True reflect pad, hann
    window zero-padded to n_fft, onesided) -> (n_fft//2+1, frames)."""
    y = np.asarray(wav, np.float64)
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    window = np.zeros(n_fft)
    lo = (n_fft - win) // 2
    window[lo:lo + win] = np.hanning(win + 1)[:win]  # periodic hann
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=1)).T


def detect_bandstop_freq(wav: np.ndarray, sr: int, win: int,
                         hop: int, max_hz: float = 300.0) -> float:
    """Adaptive bandstop placement: dominant mean-magnitude STFT bin below
    ``max_hz`` (reference filter_test.py:62-77 — note the reference passes
    n_fft=win_len to torch.stft there, so the FFT size is the window
    length).  Returns the peak frequency in Hz rounded to 2 decimals."""
    mag = _stft_mag(wav, n_fft=win, hop=hop, win=win)
    mean_energy = mag.mean(axis=1)
    n_bins = mag.shape[0]
    max_bin = int((max_hz / (sr / 2)) * n_bins)
    peak_bin = int(np.argmax(mean_energy[:max(max_bin, 1)]))
    return round((sr / 2) / n_bins * peak_bin, 2)


def apply_filter_chain(wav: np.ndarray, sr: int, cfg,
                       log: Optional[list] = None) -> np.ndarray:
    """The reference's optional filter experiments, gated by the same
    config keys (reference config.py:75-83, filter_test.py:59-98):

    1. adaptive bandstop: band-reject biquad at the dominant sub-300 Hz
       peak with Q = cfg.bandstop_q_value,
    2. highpass biquad at cfg.highpass_cutoff,
    3. lowpass biquad at cfg.lowpass_cutoff.

    ``log``, if given, collects human-readable actions taken."""
    out = np.asarray(wav, np.float32)
    if cfg.use_bandstop_filter:
        peak = detect_bandstop_freq(out, sr, win=cfg.win_len, hop=cfg.hop_len)
        if peak > 0:
            out = bandreject_biquad(out, sr, peak, q=cfg.bandstop_q_value)
            if log is not None:
                log.append(f"adaptive bandstop at {peak} Hz (Q={cfg.bandstop_q_value})")
        elif log is not None:
            log.append("adaptive bandstop skipped (no sub-300 Hz peak)")
    if cfg.use_highpass_filter:
        out = highpass_biquad(out, sr, cfg.highpass_cutoff)
        if log is not None:
            log.append(f"highpass at {cfg.highpass_cutoff} Hz")
    if cfg.use_lowpass_filter:
        out = lowpass_biquad(out, sr, cfg.lowpass_cutoff)
        if log is not None:
            log.append(f"lowpass at {cfg.lowpass_cutoff} Hz")
    return out.astype(np.float32)


def noise_frequency_analysis(mean_spec_db: np.ndarray, sr: int) -> dict:
    """Peak/Q analysis of a mean dB spectrogram (reference
    plot_noise_frequencies.py:119-134): dominant bin of the time-averaged
    spectrum plus the -3 dB bandwidth around it and the implied filter Q."""
    mean_energy = mean_spec_db.mean(axis=1)
    peak_bin = int(np.argmax(mean_energy))
    bin_hz = (sr // 2) / mean_spec_db.shape[0]
    peak_freq = round(peak_bin * bin_hz, 2)
    threshold = mean_energy[peak_bin] - 3.0
    lo = hi = peak_bin
    while lo > 0 and mean_energy[lo] >= threshold:
        lo -= 1
    while hi < len(mean_energy) - 1 and mean_energy[hi] >= threshold:
        hi += 1
    bandwidth = (hi - lo) * bin_hz
    q = round(peak_freq / bandwidth, 2) if bandwidth else 1.0
    return {"peak_bin": peak_bin, "peak_freq_hz": peak_freq,
            "bandwidth_hz": bandwidth, "q_value": q}

"""Native WORLD-protocol F0 estimation + fastdtw alignment.

The reference computes log-F0 RMSE with pyworld ``dio`` -> ``stonemask``,
mel-cepstra via ``pysptk.sp2mc(order=24, alpha=0.42)`` on a cheaptrick
envelope, and ``fastdtw`` alignment (reference evaluation/eval.py:49-79).
This module re-implements the protocol natively on numpy (a copy of the JAX
package's module: the port imports nothing of that package):

- :func:`dio_f0` — DIO's structure: a bank of low-pass channels (one per
  half-octave from f0_floor to f0_ceil), four event-interval estimators
  per channel (rising/falling zero crossings, peaks, dips), candidate =
  mean of the four, reliability = their relative spread, best channel per
  frame, spread-thresholded voicing.
- :func:`stonemask_refine` — StoneMask's refinement: a three-period
  Blackman window per voiced frame, per-bin instantaneous frequency from
  the one-sample-shift phase difference, refined F0 = amplitude²-weighted
  mean of IF(k·f0)/k over the first six harmonics.
- :func:`sp2mc` — exact SPTK math: real cepstrum of the log spectrum, then
  the ``freqt`` all-pass frequency-warping recursion (alpha=0.42).
- :func:`fastdtw_path` — Salvador & Chan FastDTW (recursive coarsening,
  radius-constrained refinement), same approximation the reference's
  monkey-patched scorer uses.
- :func:`world_log_f0_rmse` — the full protocol, drop-in comparable with
  reference absolute values.

The spectral envelope feeding sp2mc is a Hann-window STFT power spectrum
rather than cheaptrick's F0-adaptive smoothing — it is consumed only as
DTW alignment features, where the two are interchangeable; F0 values
themselves follow dio+stonemask.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from facegantts_tpu_torch.evaluation.metrics import _frames, stft_mag


# ---------------------------------------------------------------------------
# DIO
# ---------------------------------------------------------------------------

def _lowpass(x: np.ndarray, sr: int, cutoff: float) -> np.ndarray:
    """Zero-phase FFT low-pass with a cosine rolloff above `cutoff`, plus a
    50 Hz DC/rumble cut (DIO filters each channel to isolate a candidate
    fundamental)."""
    n = len(x)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    gain = np.ones_like(f)
    roll = (f > cutoff) & (f < 1.5 * cutoff)
    gain[f >= 1.5 * cutoff] = 0.0
    gain[roll] = 0.5 * (1.0 + np.cos(np.pi * (f[roll] - cutoff) / (0.5 * cutoff)))
    hp = f < 50.0
    gain[hp] *= 0.5 * (1.0 - np.cos(np.pi * f[hp] / 50.0))
    return np.fft.irfft(spec * gain, n)


def _event_f0(times: np.ndarray, frame_times: np.ndarray) -> Optional[np.ndarray]:
    """Event times (s) -> per-frame F0 by interpolating interval rates."""
    if len(times) < 3:
        return None
    intervals = np.diff(times)
    good = intervals > 1e-6
    if good.sum() < 2:
        return None
    centers = 0.5 * (times[:-1] + times[1:])[good]
    rates = 1.0 / intervals[good]
    vals = np.interp(frame_times, centers, rates)
    # np.interp clamps beyond the span — frames with no surrounding events
    # carry no information and must not report a (held) F0
    vals[(frame_times < centers[0]) | (frame_times > centers[-1])] = np.nan
    return vals


def _zero_cross_times(e: np.ndarray, sr: int, rising: bool) -> np.ndarray:
    s = e if rising else -e
    idx = np.where((s[:-1] <= 0) & (s[1:] > 0))[0]
    if len(idx) == 0:
        return np.empty(0)
    frac = -s[idx] / (s[idx + 1] - s[idx] + 1e-20)
    return (idx + frac) / sr


def dio_f0(
    x: np.ndarray,
    sr: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_period: float = 5.0,
    channels_in_octave: float = 2.0,
    allowed_range: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """DIO-protocol F0.  Returns (f0, time_axis); unvoiced frames are 0.

    Defaults match pyworld.dio's (harvest-era) defaults used by the
    reference (eval.py:57: no overrides)."""
    x = np.asarray(x, np.float64)
    if len(x) < sr // 20:
        t = np.arange(0, max(len(x) / sr, 1e-3), frame_period / 1000.0)
        return np.zeros(len(t)), t
    hop_s = frame_period / 1000.0
    frame_times = np.arange(0.0, len(x) / sr, hop_s)

    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    boundaries = f0_floor * 2.0 ** ((np.arange(n_ch) + 1) / channels_in_octave)

    best_f0 = np.zeros(len(frame_times))
    best_dev = np.full(len(frame_times), np.inf)
    for boundary in boundaries:
        e = _lowpass(x, sr, boundary)
        de = np.gradient(e)
        ests = [
            _event_f0(_zero_cross_times(e, sr, True), frame_times),
            _event_f0(_zero_cross_times(e, sr, False), frame_times),
            _event_f0(_zero_cross_times(de, sr, True), frame_times),
            _event_f0(_zero_cross_times(de, sr, False), frame_times),
        ]
        ests = [v for v in ests if v is not None]
        if len(ests) < 4:
            continue
        stack = np.stack(ests)  # (4, T)
        cand = stack.mean(axis=0)
        dev = stack.std(axis=0) / np.maximum(cand, 1e-9)
        bad = ~np.isfinite(cand)
        cand = np.where(bad, 0.0, cand)
        dev = np.where(bad, np.inf, dev)
        ok = (cand >= f0_floor) & (cand <= f0_ceil) & (dev < best_dev)
        best_f0 = np.where(ok, cand, best_f0)
        best_dev = np.where(ok, dev, best_dev)

    f0 = np.where(best_dev < allowed_range, best_f0, 0.0)
    # silence gate: frames whose 25 ms local RMS is < -40 dB of the
    # utterance peak RMS carry no periodicity evidence
    win = max(1, int(0.025 * sr))
    e2 = np.concatenate([[0.0], np.cumsum(x ** 2)])
    ci = np.clip((frame_times * sr).astype(int), 0, len(x))
    lo = np.clip(ci - win // 2, 0, len(x))
    hi = np.clip(ci + win // 2, 0, len(x))
    rms = np.sqrt((e2[hi] - e2[lo]) / np.maximum(hi - lo, 1))
    f0[rms < 0.01 * (rms.max() + 1e-12)] = 0.0
    # step 5-ish continuity fix: kill isolated voiced frames and octave jumps
    voiced = f0 > 0
    for i in range(1, len(f0) - 1):
        if voiced[i] and not (voiced[i - 1] or voiced[i + 1]):
            f0[i] = 0.0
    return f0, frame_times


# ---------------------------------------------------------------------------
# StoneMask
# ---------------------------------------------------------------------------

def stonemask_refine(
    x: np.ndarray, f0: np.ndarray, time_axis: np.ndarray, sr: int,
    n_harmonics: int = 6,
) -> np.ndarray:
    """Refine DIO F0 by instantaneous frequency around the harmonics."""
    x = np.asarray(x, np.float64)
    out = f0.copy()
    for i, (t0, f) in enumerate(zip(time_axis, f0)):
        if f <= 0:
            continue
        half = int(1.5 * sr / f)
        c = int(t0 * sr)
        lo, hi = c - half, c + half + 1
        if lo < 0 or hi + 1 > len(x):
            continue
        seg = x[lo:hi]
        win = np.blackman(len(seg))
        nfft = int(2 ** np.ceil(np.log2(len(seg) * 2)))
        s0 = np.fft.rfft(seg * win, nfft)
        s1 = np.fft.rfft(x[lo + 1:hi + 1] * win, nfft)
        # per-bin instantaneous frequency from the one-sample phase advance
        dphi = np.angle(s1 * np.conj(s0))
        inst = dphi * sr / (2.0 * np.pi)
        mag2 = np.abs(s0) ** 2
        bin_hz = sr / nfft
        num = den = 0.0
        for k in range(1, n_harmonics + 1):
            b = int(round(k * f / bin_hz))
            if b <= 0 or b >= len(inst):
                break
            w = mag2[b]
            est = inst[b] / k
            if est <= 0:
                continue
            num += w * est
            den += w
        if den > 0:
            refined = num / den
            if 0.5 * f < refined < 2.0 * f:
                out[i] = refined
    return out


def world_f0(x: np.ndarray, sr: int, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """dio -> stonemask, the reference's F0 protocol (eval.py:56-58)."""
    f0, t = dio_f0(x, sr, **kw)
    return stonemask_refine(x, f0, t, sr), t


# ---------------------------------------------------------------------------
# sp2mc (SPTK freqt math)
# ---------------------------------------------------------------------------

def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """SPTK frequency-warping recursion (all-pass bilinear transform)."""
    beta = 1.0 - alpha * alpha
    d = np.zeros(order + 1)
    for ci in c[::-1]:
        g = np.empty(order + 1)
        g[0] = ci + alpha * d[0]
        if order >= 1:
            g[1] = beta * d[0] + alpha * d[1]
        for m in range(2, order + 1):
            g[m] = d[m - 1] + alpha * (d[m] - g[m - 1])
        d = g
    return d


def sp2mc(sp: np.ndarray, order: int = 24, alpha: float = 0.42) -> np.ndarray:
    """Power spectrum frames (T, bins) -> mel-cepstra (T, order+1)."""
    logsp = 0.5 * np.log(np.maximum(sp, 1e-20))
    cep = np.fft.irfft(logsp, axis=-1)  # real cepstrum, full length
    half = cep.shape[-1] // 2
    c = cep[:, : half + 1].copy()
    c[:, 1:half] *= 2.0  # fold negative quefrencies
    return np.stack([freqt(row, order, alpha) for row in c])


def world_mcep(x: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 80,
               order: int = 24, alpha: float = 0.42) -> np.ndarray:
    """Alignment mel-cepstra at the WORLD 5 ms frame rate (hop = sr/200)."""
    mag = stft_mag(np.asarray(x, np.float64), n_fft, hop)
    return sp2mc(mag ** 2, order, alpha)


# ---------------------------------------------------------------------------
# FastDTW (Salvador & Chan 2007)
# ---------------------------------------------------------------------------

def _dtw_window(a: np.ndarray, b: np.ndarray, window) -> Tuple[np.ndarray, np.ndarray]:
    """DTW restricted to `window` (iterable of (i, j)); returns the path."""
    inf = np.inf
    cost: Dict[Tuple[int, int], Tuple[float, Tuple[int, int]]] = {(-1, -1): (0.0, (-1, -1))}
    window = sorted(window)
    for i, j in window:
        d = float(np.linalg.norm(a[i] - b[j]))
        best, prev = inf, None
        for pi, pj in ((i - 1, j - 1), (i - 1, j), (i, j - 1)):
            c = cost.get((pi, pj), (inf, None))[0]
            if c < best:
                best, prev = c, (pi, pj)
        cost[(i, j)] = (best + d, prev)
    # backtrack
    end = (len(a) - 1, len(b) - 1)
    if end not in cost or not np.isfinite(cost[end][0]):
        # degenerate window (shouldn't happen with inflated paths): full DTW
        return _dtw_window(a, b, _full_window(len(a), len(b)))
    path = []
    node = end
    while node != (-1, -1):
        path.append(node)
        node = cost[node][1]
    path.reverse()
    ia = np.array([p[0] for p in path])
    ib = np.array([p[1] for p in path])
    return ia, ib


def _full_window(n: int, m: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(n) for j in range(m)]


def fastdtw_path(a: np.ndarray, b: np.ndarray, radius: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """FastDTW alignment path between feature sequences (n, d), (m, d)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 1:
        a = a[:, None]
    if b.ndim == 1:
        b = b[:, None]
    n, m = len(a), len(b)
    min_size = radius + 2
    if n <= min_size or m <= min_size:
        return _dtw_window(a, b, _full_window(n, m))

    def coarsen(s):
        k = len(s) // 2 * 2
        return 0.5 * (s[0:k:2] + s[1:k:2])

    ia, ib = fastdtw_path(coarsen(a), coarsen(b), radius)
    # project the coarse path up and inflate by `radius`
    window = set()
    for ci, cj in zip(ia, ib):
        for di in range(-radius, radius + 2):
            for dj in range(-radius, radius + 2):
                i, j = 2 * ci + di, 2 * cj + dj
                if 0 <= i < n and 0 <= j < m:
                    window.add((i, j))
    # ensure corners are reachable
    window.add((0, 0))
    window.add((n - 1, m - 1))
    return _dtw_window(a, b, window)


# ---------------------------------------------------------------------------
# the full reference protocol
# ---------------------------------------------------------------------------

def world_log_f0_rmse(ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int) -> float:
    """Reference F0-RMSE protocol (eval.py:49-79): WORLD-style F0 on both
    wavs, fastdtw on order-24 alpha-0.42 mel-cepstra, log-RMSE over
    mutually voiced aligned frames."""
    gen_f0, _ = world_f0(gen_wav, sr)
    ref_f0, _ = world_f0(ref_wav, sr)
    gen_mc = world_mcep(gen_wav, sr)
    ref_mc = world_mcep(ref_wav, sr)
    ia, ib = fastdtw_path(gen_mc, ref_mc)
    fa = gen_f0[np.minimum(ia, len(gen_f0) - 1)]
    fb = ref_f0[np.minimum(ib, len(ref_f0) - 1)]
    voiced = (fa > 0) & (fb > 0)
    if voiced.sum() == 0:
        return 0.0
    return float(np.sqrt(np.mean((np.log(fa[voiced]) - np.log(fb[voiced])) ** 2)))

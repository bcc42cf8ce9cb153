"""Probabilistic YIN (pYIN) F0 estimation.

A copy of the JAX package's module of the same name: the port imports
nothing of that package, so it keeps its own.

The reference's ``VoiceFeatureExtractor.extract_f0`` is ``librosa.pyin``
(reference model/feature_extractor.py:33-41), called with
``fmin=note_to_hz("C2")``, ``fmax=note_to_hz("C7")`` and librosa defaults
otherwise; unvoiced frames are then ``nan_to_num``-ed to 0.  librosa is not
available in this image, so this module implements the pYIN algorithm
(Mauch & Dixon 2014) directly on numpy/scipy with the same structure and
defaults:

1. cumulative mean normalized difference (CMNDF) per frame, computed with
   the autocorrelation identity over an FFT;
2. trough candidates weighted by a Beta(2, 18) prior over YIN thresholds
   and a Boltzmann prior over trough order (first trough favored);
3. a voiced/unvoiced HMM over log-spaced pitch bins (triangular local
   pitch-transition window, small voicing switch probability) decoded
   with Viterbi.

This is the *protocol-faithful* pitch path.  Pure host-side numpy: pitch
extraction is an aux/eval path in
the reference too (face_tts_w_discriminator.py:265-275 runs it on CPU on
sample[0] only), never on the accelerator.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# librosa.note_to_hz("C2") / ("C7") with A440 tuning — the reference's
# search range (model/feature_extractor.py:36-37).
C2_HZ = 65.40639132514966
C7_HZ = 2093.004522404789


def _frame(y: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(y) - frame_length)) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n)[:, None]
    return y[idx]


def _cmndf(
    frames: np.ndarray, win_length: int, max_period: int
) -> np.ndarray:
    """Cumulative mean normalized difference, (F, max_period + 1).

    d_f(tau) = sum_{j<win} (y[j] - y[j+tau])^2 via the autocorrelation
    identity; then d'(0) = 1, d'(tau) = d(tau) * tau / sum_{j<=tau} d(j).
    """
    f, frame_length = frames.shape
    nfft = 1           # next pow2 >= frame_length + win_length
    while nfft < frame_length + win_length:
        nfft *= 2
    spec = np.fft.rfft(frames, nfft, axis=-1)
    head = np.fft.rfft(frames[:, :win_length], nfft, axis=-1)
    # cross term c(tau) = sum_{j<win} y[j] * y[j+tau]
    corr = np.fft.irfft(spec * np.conj(head), nfft, axis=-1)[
        :, : max_period + 1
    ]
    sq = np.concatenate(
        [np.zeros((f, 1)), np.cumsum(frames**2, axis=-1)], axis=-1
    )
    e_head = sq[:, win_length] - sq[:, 0]           # (F,)
    taus = np.arange(max_period + 1)
    e_tail = sq[:, taus + win_length] - sq[:, taus]  # (F, max_period+1)
    d = np.maximum(e_head[:, None] + e_tail - 2.0 * corr, 0.0)
    cmndf = np.ones_like(d)
    run = np.cumsum(d[:, 1:], axis=-1)
    cmndf[:, 1:] = d[:, 1:] * taus[None, 1:] / np.maximum(run, 1e-12)
    # (near-)silent frames have an all-zero difference function, which
    # would read as a perfect trough below every threshold; flatten the
    # curve at 1 so they contribute no voiced candidates
    silent = e_head < 1e-8 * win_length
    cmndf[silent] = 1.0
    return cmndf


def _parabolic_shifts(x: np.ndarray) -> np.ndarray:
    """Sub-sample trough refinement offsets for every interior index."""
    shifts = np.zeros_like(x)
    denom = x[..., :-2] - 2.0 * x[..., 1:-1] + x[..., 2:]
    num = x[..., :-2] - x[..., 2:]
    ok = np.abs(denom) > 1e-12
    shifts[..., 1:-1] = np.where(ok, 0.5 * num / np.where(ok, denom, 1.0), 0.0)
    return np.clip(shifts, -1.0, 1.0)


def _boltzmann_pmf(k: np.ndarray, lam: float, n: np.ndarray) -> np.ndarray:
    """Truncated discrete exponential over trough order 0..n-1."""
    n = np.maximum(n, 1)
    norm = (1.0 - np.exp(-lam)) / (1.0 - np.exp(-lam * n))
    return norm * np.exp(-lam * k)


def pyin(
    y: np.ndarray,
    sr: int,
    fmin: float = C2_HZ,
    fmax: float = C7_HZ,
    frame_length: int = 2048,
    win_length: int | None = None,
    hop_length: int | None = None,
    n_thresholds: int = 100,
    beta_parameters: Tuple[float, float] = (2.0, 18.0),
    boltzmann_parameter: float = 2.0,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    center: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pYIN pitch track.

    Returns ``(f0, voiced_flag, voiced_prob)``, each of shape (n_frames,).
    ``f0`` is 0.0 on unvoiced frames (the reference nan_to_nums librosa's
    NaNs to 0 immediately, model/feature_extractor.py:40 — we skip the NaN
    round-trip).
    """
    from scipy import stats

    y = np.asarray(y, np.float64)
    win_length = win_length or frame_length // 2
    hop_length = hop_length or frame_length // 4
    if center:
        y = np.pad(y, frame_length // 2)
    if len(y) < frame_length:
        y = np.pad(y, (0, frame_length - len(y)))

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(
        int(np.ceil(sr / fmin)), frame_length - win_length - 1
    )
    frames = _frame(y, frame_length, hop_length)
    n_frames = len(frames)
    cmndf = _cmndf(frames, win_length, max_period)
    shifts = _parabolic_shifts(cmndf)

    # threshold grid and Beta prior over thresholds
    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)
    beta_probs = np.diff(stats.beta.cdf(thresholds, *beta_parameters))

    # pitch-bin grid (log-spaced), voiced states then unvoiced states
    n_bins_per_semitone = int(np.ceil(1.0 / resolution))
    n_pitch_bins = int(
        np.floor(12 * n_bins_per_semitone * np.log2(fmax / fmin))
    ) + 1
    observation = np.zeros((n_frames, 2 * n_pitch_bins))
    observation[:, n_pitch_bins:] = 1.0 / n_pitch_bins  # default: unvoiced

    search = cmndf[:, min_period : max_period + 1]
    search_shifts = shifts[:, min_period : max_period + 1]
    frame_energy = np.mean(frames**2, axis=-1)
    for t in range(n_frames):
        if frame_energy[t] < 1e-10:  # silent frame: no voiced candidates
            continue
        x = search[t]
        # trough detection (local minima; strict on the left)
        trough = np.zeros(len(x), bool)
        trough[1:-1] = (x[1:-1] < x[:-2]) & (x[1:-1] <= x[2:])
        idx = np.flatnonzero(trough)
        if len(idx) == 0:
            idx = np.array([int(np.argmin(x))])
        heights = x[idx]

        below = heights[:, None] < thresholds[None, 1:]
        positions = np.cumsum(below, axis=0) - 1
        n_below = below.sum(axis=0)
        prior = np.where(
            below,
            _boltzmann_pmf(
                positions, boltzmann_parameter, n_below[None, :]
            ),
            0.0,
        )
        trough_probs = prior @ beta_probs
        # thresholds exceeded by every trough: small mass on the global min
        empty = n_below == 0
        if empty.any():
            trough_probs[int(np.argmin(heights))] += (
                no_trough_prob * beta_probs[empty].sum()
            )

        periods = idx + min_period + search_shifts[t, idx]
        freqs = sr / np.maximum(periods, 1e-6)
        bins = np.clip(
            np.round(
                12 * n_bins_per_semitone * np.log2(freqs / fmin)
            ).astype(int),
            0,
            n_pitch_bins - 1,
        )
        voiced_prob = min(float(trough_probs.sum()), 1.0)
        row = observation[t]
        np.add.at(row, bins, trough_probs)
        row[n_pitch_bins:] = (1.0 - voiced_prob) / n_pitch_bins

    states = _viterbi(
        observation,
        n_pitch_bins,
        n_bins_per_semitone,
        hop_length / sr,
        max_transition_rate,
        switch_prob,
    )
    voiced_flag = states < n_pitch_bins
    pitch_bin = np.where(voiced_flag, states, states - n_pitch_bins)
    f0 = fmin * 2.0 ** (pitch_bin / (12.0 * n_bins_per_semitone))
    f0 = np.where(voiced_flag, f0, 0.0)
    voiced_prob = observation[:, :n_pitch_bins].sum(axis=1)
    return f0, voiced_flag, np.clip(voiced_prob, 0.0, 1.0)


def _viterbi(
    observation: np.ndarray,
    n_pitch_bins: int,
    n_bins_per_semitone: int,
    frame_period_s: float,
    max_transition_rate: float,
    switch_prob: float,
) -> np.ndarray:
    """Decode the voiced/unvoiced pitch HMM (2 * n_pitch_bins states).

    Transition = kron([[1-s, s], [s, 1-s]], L) where L is a row-normalized
    triangular window over pitch bins whose half-width tracks the maximum
    pitch slew (octaves/s) per frame hop.
    """
    half = max(
        1,
        int(
            round(
                max_transition_rate
                * 12
                * n_bins_per_semitone
                * frame_period_s
            )
        ),
    )
    offs = np.arange(-half, half + 1)
    tri = (half + 1 - np.abs(offs)).astype(np.float64)
    i = np.arange(n_pitch_bins)
    cols = i[:, None] + offs[None, :]
    valid = (cols >= 0) & (cols < n_pitch_bins)
    local = np.zeros((n_pitch_bins, n_pitch_bins))
    rows = np.repeat(i, len(offs))[valid.ravel()]
    local[rows, cols[valid]] = np.tile(tri, n_pitch_bins)[valid.ravel()]
    local /= local.sum(axis=1, keepdims=True)

    eps = 1e-12
    log_local = np.log(local + eps)
    log_stay = np.log1p(-switch_prob)
    log_switch = np.log(switch_prob)
    log_obs = np.log(observation + eps)

    n_frames, n_states = observation.shape
    # uniform init over unvoiced states
    delta = np.full(n_states, np.log(eps))
    delta[n_pitch_bins:] = -np.log(n_pitch_bins)
    delta = delta + log_obs[0]
    back = np.zeros((n_frames, n_states), np.int32)
    v, u = slice(0, n_pitch_bins), slice(n_pitch_bins, n_states)
    for t in range(1, n_frames):
        # best predecessor within each voicing block (shared local window)
        cand_v = delta[v][:, None] + log_local  # (from, to)
        cand_u = delta[u][:, None] + log_local
        arg_v, arg_u = cand_v.argmax(axis=0), cand_u.argmax(axis=0)
        best_v = cand_v[arg_v, np.arange(n_pitch_bins)]
        best_u = cand_u[arg_u, np.arange(n_pitch_bins)]
        # to-voiced: stay from voiced vs switch from unvoiced
        to_v_stay = best_v + log_stay
        to_v_switch = best_u + log_switch
        take_stay = to_v_stay >= to_v_switch
        new_v = np.where(take_stay, to_v_stay, to_v_switch)
        back[t, v] = np.where(take_stay, arg_v, arg_u + n_pitch_bins)
        # to-unvoiced: stay from unvoiced vs switch from voiced
        to_u_stay = best_u + log_stay
        to_u_switch = best_v + log_switch
        take_stay = to_u_stay >= to_u_switch
        new_u = np.where(take_stay, to_u_stay, to_u_switch)
        back[t, u] = np.where(
            take_stay, arg_u + n_pitch_bins, arg_v
        )
        delta = np.concatenate([new_v, new_u]) + log_obs[t]

    states = np.zeros(n_frames, np.int64)
    states[-1] = int(np.argmax(delta))
    for t in range(n_frames - 1, 0, -1):
        states[t - 1] = back[t, states[t]]
    return states

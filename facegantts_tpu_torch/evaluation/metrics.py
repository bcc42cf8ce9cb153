"""Objective evaluation metrics (reference evaluation/eval.py:26-279).

A copy of the JAX package's module of the same name: the port imports
nothing of that package, so it keeps its own.

All metrics are implemented natively (no pyworld/pysptk/librosa/fastdtw):

- speaker similarity: cosine of time-pooled SyncNet audio embeddings
  (eval.py:26-44).
- log-F0 RMSE: YIN-style F0 per frame, DTW alignment on mel-cepstra, RMSE of
  log-F0 over mutually voiced frames (eval.py:49-79 uses WORLD dio+stonemask
  + fastdtw; same protocol, different estimator).
- MCD: mel-cepstra (DCT of log-mel spectrum, c1..c24) DTW-aligned,
  (10/ln10)*sqrt(2*Σd²) (eval.py:214 via the mel-cepstral-distance package).
- log-spectral distance: per-frame RMSE of log10 |STFT| over the common
  length (eval.py:81-95).
- composite: mean of the four normalized errors with the reference's exact
  normalization constants (eval.py:229-253).
"""

from typing import Dict, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _frames(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    if len(y) < n_fft:
        y = np.pad(y, (0, n_fft - len(y)))
    n = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    return y[idx]


def stft_mag(y: np.ndarray, n_fft: int = 1024, hop: int = 160) -> np.ndarray:
    """(T, n_fft//2+1) magnitude spectrogram, Hann window."""
    win = np.hanning(n_fft + 1)[:-1]
    return np.abs(np.fft.rfft(_frames(y, n_fft, hop) * win, axis=-1))


def yin_f0(
    y: np.ndarray,
    sr: int,
    fmin: float = 65.0,
    fmax: float = 1000.0,
    frame_len: int = 1024,
    hop: int = 160,
    threshold: float = 0.15,
) -> np.ndarray:
    """Frame-wise F0 via YIN (cumulative mean normalized difference).

    Returns 0.0 for unvoiced frames."""
    y = np.asarray(y, np.float64)
    tau_min = max(2, int(sr / fmax))
    tau_max = min(frame_len - 1, int(sr / fmin))
    frames = _frames(y, frame_len, hop)
    out = np.zeros(len(frames))
    for i, fr in enumerate(frames):
        # difference function via autocorrelation identity
        r = np.fft.irfft(np.abs(np.fft.rfft(fr, 2 * frame_len)) ** 2)[: frame_len]
        cum = np.cumsum(fr**2)
        energy = cum[-1]
        if energy < 1e-6 * frame_len:  # silent frame: unvoiced
            continue
        d = energy + (energy - np.concatenate([[0.0], cum[:-1]])) - 2 * r
        d = d[: tau_max + 1]
        # cumulative mean normalized difference
        cmndf = np.ones_like(d)
        run = np.cumsum(d[1:])
        cmndf[1:] = d[1:] * np.arange(1, len(d)) / np.maximum(run, 1e-12)
        seg = cmndf[tau_min:]
        below = np.where(seg < threshold)[0]
        tau = (below[0] + tau_min) if len(below) else (int(np.argmin(seg)) + tau_min)
        if cmndf[tau] < 0.5:  # voicing decision
            # parabolic refinement
            if 1 <= tau < len(cmndf) - 1:
                a, b, c = cmndf[tau - 1], cmndf[tau], cmndf[tau + 1]
                denom = a + c - 2 * b
                if abs(denom) > 1e-12:
                    tau = tau + 0.5 * (a - c) / denom
            out[i] = sr / tau
    return out


def mel_cepstra(
    y: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 160,
    n_mels: int = 40, n_mcep: int = 25,
) -> np.ndarray:
    """(T, n_mcep) mel-cepstral coefficients via DCT-II of the log-mel
    spectrum (c0 retained; MCD consumers drop it)."""
    from facegantts_tpu_torch.ops.mel import mel_filterbank

    mag = stft_mag(y, n_fft, hop)  # (T, bins)
    fb = mel_filterbank(sr, n_fft, n_mels, 0.0, sr / 2.0)  # (n_mels, bins)
    logmel = np.log(np.maximum(mag @ fb.T, 1e-8))
    t = logmel.shape[0]
    n = np.arange(n_mels)
    dct = np.cos(np.pi * np.outer(np.arange(n_mcep), (2 * n + 1) / (2 * n_mels)))
    return logmel @ dct.T * np.sqrt(2.0 / n_mels)


def dtw_path(a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Classic O(nm) DTW on feature sequences, euclidean local cost.

    Returns aligned index arrays (ia, ib)."""
    n, m = len(a), len(b)
    # pairwise distances
    d = np.sqrt(
        np.maximum(
            (a**2).sum(1)[:, None] + (b**2).sum(1)[None, :] - 2 * a @ b.T, 0.0
        )
    )
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        prev = acc[i - 1]
        cur = acc[i]
        row = d[i - 1]
        for j in range(1, m + 1):
            cur[j] = row[j - 1] + min(prev[j], cur[j - 1], prev[j - 1])
    # backtrack
    ia, ib = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ia.append(i - 1)
        ib.append(j - 1)
        step = np.argmin([acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1]])
        if step == 0:
            i, j = i - 1, j - 1
        elif step == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ia[::-1]), np.array(ib[::-1])


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def speaker_similarity(syncnet_apply, ref_mel, syn_mel) -> Tuple[float, float]:
    """Cosine similarity of mean-pooled SyncNet audio embeddings.

    syncnet_apply: callable (mel (B, n_mels, T, 1)) -> (B, T', D)."""
    er = np.asarray(syncnet_apply(ref_mel[None, :, :, None])).mean(axis=1)[0]
    es = np.asarray(syncnet_apply(syn_mel[None, :, :, None])).mean(axis=1)[0]
    er = er / (np.linalg.norm(er) + 1e-8)
    es = es / (np.linalg.norm(es) + 1e-8)
    sim = float(np.dot(er, es))
    return 1.0 - sim, sim


def log_f0_rmse(
    ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int, estimator: str = "yin"
) -> float:
    """RMSE of log-F0 over DTW-aligned mutually voiced frames.

    ``estimator``: "yin" (fast, threshold YIN above) or "pyin" (HMM-smoothed
    probabilistic YIN matching the reference's C10 extractor, evaluation/
    pyin.py; note its librosa-default hop of 512 vs yin_f0's 160 — the DTW
    index clamp below absorbs the coarser frame grid)."""
    ref_mc = mel_cepstra(ref_wav, sr)
    gen_mc = mel_cepstra(gen_wav, sr)
    ia, ib = dtw_path(gen_mc, ref_mc)
    if estimator == "pyin":
        from facegantts_tpu_torch.evaluation.pyin import pyin

        hop_ratio = 512 / 160.0  # pyin frames are coarser than the cepstra
        f0_ref = pyin(ref_wav, sr)[0]
        f0_gen = pyin(gen_wav, sr)[0]
        ia = (ia / hop_ratio).astype(int)
        ib = (ib / hop_ratio).astype(int)
    else:
        f0_ref = yin_f0(ref_wav, sr)
        f0_gen = yin_f0(gen_wav, sr)
    fa = f0_gen[np.minimum(ia, len(f0_gen) - 1)]
    fb = f0_ref[np.minimum(ib, len(f0_ref) - 1)]
    voiced = (fa > 0) & (fb > 0)
    if voiced.sum() == 0:
        return 0.0
    return float(np.sqrt(np.mean((np.log(fa[voiced]) - np.log(fb[voiced])) ** 2)))


def mcd(ref_wav: np.ndarray, gen_wav: np.ndarray, sr: int) -> float:
    """Mel-cepstral distortion in dB over DTW-aligned frames, c1..c24."""
    ref_mc = mel_cepstra(ref_wav, sr)[:, 1:]
    gen_mc = mel_cepstra(gen_wav, sr)[:, 1:]
    ia, ib = dtw_path(gen_mc, ref_mc)
    diff = gen_mc[ia] - ref_mc[ib]
    return float(
        np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * (diff**2).sum(axis=1)))
    )


def log_spectral_distance(
    ref_wav: np.ndarray, gen_wav: np.ndarray, n_fft: int = 1024, hop: int = 160
) -> float:
    """Mean per-frame RMSE of log10 magnitudes over the common length."""
    r = stft_mag(ref_wav, n_fft, hop)
    g = stft_mag(gen_wav, n_fft, hop)
    t = min(len(r), len(g))
    rl = np.log10(r[:t] + 1e-8)
    gl = np.log10(g[:t] + 1e-8)
    return float(np.mean(np.sqrt(np.mean((rl - gl) ** 2, axis=1))))


def composite_metric(
    mean_speaker_sim: float, mean_f0: float, mean_mcd: float, mean_lsd: float
) -> float:
    """Reference normalization (eval.py:229-253): speaker error 1-sim;
    F0 clipped at 1.0 nats; MCD mapped [4,12]->[0,1]; LSD mapped [0,2]->[0,1]."""
    norm_speaker = 1.0 - mean_speaker_sim
    norm_f0 = min(mean_f0 / 1.0, 1.0)
    norm_mcd = min(max((mean_mcd - 4.0) / 8.0, 0.0), 1.0)
    norm_lsd = min(max(mean_lsd / 2.0, 0.0), 1.0)
    return (norm_speaker + norm_f0 + norm_mcd + norm_lsd) / 4.0


def format_eval_output(metrics: Dict[str, float]) -> str:
    """eval_output.txt format the reference tooling regex-parses
    (custom_callbacks.py:13-55, hyperopt.py:102-124)."""
    return "".join(f"{k}: {v:.6f}\n" for k, v in metrics.items())

"""Host-side voice feature extraction (mel / F0 / energy).

A copy of the JAX package's module of the same name: the port imports
nothing of that package, so it keeps its own.

Mirror of the reference's ``VoiceFeatureExtractor``
(model/feature_extractor.py:5-49), which the GAN wrapper uses for the
optional pitch/energy contour losses on sample[0] of each micro-batch
(face_tts_w_discriminator.py:265-282, off by default) and which defines
the librosa conventions those features follow:

- ``extract_mel_spectrogram``: *centered* STFT (Hann, zero pad-to-n_fft),
  magnitude, Slaney mel filterbank — librosa.stft defaults, NOT the
  HiFi-GAN reflect-pad mel of ops/mel.py (reference uses librosa defaults
  here, feature_extractor.py:17-31).
- ``extract_f0``: pYIN over [C2, C7] (feature_extractor.py:33-41);
  implemented in evaluation/pyin.py; NaN->0 like the reference.
- ``extract_energy``: centered frame RMS, frame_length=n_fft
  (feature_extractor.py:46-49 / librosa.feature.rms).

Everything is numpy on the host: in the reference these run on the CPU
inside the train loop; this class carries the protocol-faithful
monitoring/eval variant.
"""

from __future__ import annotations

import numpy as np

from facegantts_tpu_torch.evaluation.pyin import C2_HZ, C7_HZ, pyin
from facegantts_tpu_torch.ops.mel import mel_filterbank


def _centered_frames(y: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    y = np.pad(np.asarray(y, np.float64), frame_length // 2)
    n = 1 + max(0, (len(y) - frame_length)) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n)[:, None]
    return y[idx]


class VoiceFeatureExtractor:
    """Config keys match the reference constructor (feature_extractor.py:6-13)."""

    def __init__(self, cfg):
        get = cfg.get if isinstance(cfg, dict) else lambda k: getattr(cfg, k)
        self.sampling_rate = int(get("sample_rate"))
        self.hop_length = int(get("hop_len"))
        self.filter_length = int(get("n_fft"))
        self.win_length = int(get("win_len"))
        self.n_mels = int(get("n_mels"))
        self.mel_fmin = float(get("f_min"))
        self.mel_fmax = float(get("f_max"))

    def extract_mel_spectrogram(self, wav: np.ndarray) -> np.ndarray:
        """(n_mels, T) linear-magnitude mel, librosa.stft conventions."""
        frames = _centered_frames(wav, self.filter_length, self.hop_length)
        # Hann of win_length, centered zero-pad to n_fft (librosa window
        # handling for win_length < n_fft)
        win = np.zeros(self.filter_length)
        start = (self.filter_length - self.win_length) // 2
        win[start : start + self.win_length] = np.hanning(self.win_length + 1)[:-1]
        mag = np.abs(np.fft.rfft(frames * win, axis=-1)).T  # (bins, T)
        fb = mel_filterbank(
            self.sampling_rate, self.filter_length, self.n_mels,
            self.mel_fmin, self.mel_fmax,
        )
        return (fb @ mag).astype(np.float32)

    def extract_f0(self, wav: np.ndarray) -> np.ndarray:
        """(1, T') pYIN F0 in Hz, 0.0 on unvoiced frames."""
        f0, _, _ = pyin(
            np.asarray(wav, np.float64),
            sr=self.sampling_rate,
            fmin=C2_HZ,
            fmax=C7_HZ,
        )
        return np.nan_to_num(f0, nan=0.0, posinf=0.0, neginf=0.0)[
            None, :
        ].astype(np.float32)

    def extract_energy(self, wav: np.ndarray) -> np.ndarray:
        """(T,) frame RMS, frame_length = n_fft, centered."""
        frames = _centered_frames(wav, self.filter_length, self.hop_length)
        rms = np.sqrt(np.mean(frames**2, axis=-1))
        return np.nan_to_num(rms, nan=0.0, posinf=0.0, neginf=0.0).astype(
            np.float32
        )

"""Waveform IO (scipy-backed; no soundfile/librosa dependency), a copy of
the JAX package's ``utils/audio.py``: the reference's load path
(utils/mel_spectrogram.py:13-15 via scipy.io.wavfile + librosa normalize)
and the int16 writeout used by inference (reference inference.py:136-145).
"""

import numpy as np
from scipy.io import wavfile

MAX_WAV_VALUE = 32768.0


def load_wav(path: str, normalize: bool = True):
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.ndim == 2:  # downmix
        data = data.mean(axis=1)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / MAX_WAV_VALUE
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if normalize:
        peak = np.abs(wav).max()
        if peak > 1.0:
            wav = wav / peak
    return wav, sr


def save_wav(path: str, wav, sample_rate: int):
    """Write float waveform in [-1, 1] as int16 PCM."""
    wav = np.asarray(wav, dtype=np.float32)
    pcm = (np.clip(wav, -1.0, 1.0) * MAX_WAV_VALUE).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)

"""N-way cross-modal face<->voice retrieval accuracy
(reference evaluation/acc_measure.py:17-98), in the PyTorch port.

Port of the JAX package's ``evaluation/acc_measure.py``: SyncNet's two
streams run on the card unless ``device=cpu``.

For each trial: one probe voice embedding, N candidate face embeddings (the
matching speaker + N-1 distractors); retrieval is correct when the matching
face has the highest cosine similarity.  Reports accuracy over `n_trials`
random trials both directions (face->voice and voice->face).

Usage:
  python -m facegantts_tpu_torch.evaluation.acc_measure packed_data_dir=... \
      [n_way=5] [n_trials=100] [syncnet_ckpt=...] [bandpass=0] [device=cpu]

bandpass=1 reruns the measurement with a 300 Hz - 4 kHz band-pass applied to
the voice input — the reference's sanity check that retrieval tracks the
speaker rather than out-of-band noise (acc_measure.py:55-57,87-98, which
uses torchaudio biquads on the wav; here the band-limit is applied in the
mel domain by flooring out-of-band filterbank bins).
"""

import sys
from typing import Callable, Dict

import numpy as np

from facegantts_tpu_torch.config import default_config, parse_cli_overrides


def retrieval_accuracy(
    voice_embs: np.ndarray,
    face_embs: np.ndarray,
    n_way: int = 5,
    n_trials: int = 100,
    seed: int = 37,
) -> Dict[str, float]:
    """voice_embs/face_embs: (N, D) paired by row (same speaker per row)."""
    n = len(voice_embs)
    assert n >= n_way, f"need at least n_way={n_way} items, have {n}"
    v = voice_embs / (np.linalg.norm(voice_embs, axis=1, keepdims=True) + 1e-8)
    f = face_embs / (np.linalg.norm(face_embs, axis=1, keepdims=True) + 1e-8)
    rng = np.random.default_rng(seed)
    correct_v2f = correct_f2v = 0
    for _ in range(n_trials):
        cand = rng.choice(n, size=n_way, replace=False)
        probe = cand[0]
        sims_v2f = f[cand] @ v[probe]
        correct_v2f += int(np.argmax(sims_v2f) == 0)
        sims_f2v = v[cand] @ f[probe]
        correct_f2v += int(np.argmax(sims_f2v) == 0)
    return {
        "voice_to_face_acc": correct_v2f / n_trials,
        "face_to_voice_acc": correct_f2v / n_trials,
        "n_way": float(n_way),
        "n_trials": float(n_trials),
    }


def biquad_bandpass(wav: np.ndarray, sr: int, lo: float = 300.0,
                    hi: float = 4000.0, q: float = 0.7071067811865476,
                    ) -> np.ndarray:
    """The reference's EXACT band-pass: RBJ-cookbook highpass(lo) then
    lowpass(hi) biquads — the same coefficients and difference equation
    torchaudio.functional.{highpass,lowpass}_biquad applies (reference
    acc_measure.py:55-57,96-97), including torchaudio's default output
    clamp to [-1, 1] after each filter.  Use on raw waveforms; for
    packed mel-only data see :func:`mel_bandpass` (delta quantified in
    tests/test_world.py)."""
    from facegantts_tpu_torch.data.filters import highpass_biquad, lowpass_biquad

    out = highpass_biquad(wav, sr, lo, q)
    out = lowpass_biquad(out, sr, hi, q)
    return out.astype(np.float32)


def mel_bandpass(mel: np.ndarray, sr: int, n_mels: int, f_min: float,
                 f_max: float, lo: float = 300.0, hi: float = 4000.0) -> np.ndarray:
    """Floor mel bins whose center frequency lies outside [lo, hi] Hz
    (mel-domain approximation of the reference's highpass+lowpass biquads,
    for packed data that stores mels only; :func:`biquad_bandpass` is the
    exact wav-domain protocol).  Centers use the same Slaney scale as the
    mel filterbank (ops/mel.py) so the kept-bin set matches the actual
    filterbank geometry."""
    from facegantts_tpu_torch.ops.mel import hz_to_mel_slaney, mel_to_hz_slaney

    f_max = f_max or sr / 2.0
    mels = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max),
                       n_mels + 2)
    centers = mel_to_hz_slaney(mels[1:-1])  # (n_mels,)
    keep = (centers >= lo) & (centers <= hi)
    out = mel.copy()
    out[~keep, :] = mel.min()
    return out


def embed_dataset(dataset, syncnet_vid: Callable, syncnet_aud: Callable,
                  limit: int = 200, band=None):
    """Compute paired (voice, face) embeddings over dataset items.

    band=(sr, n_mels, f_min, f_max) applies the band-pass sanity filter."""
    v, f = [], []
    for i in range(min(limit, len(dataset))):
        item = dataset[i]
        mel = item["y"]
        if band is not None:
            mel = mel_bandpass(mel, *band)
        mel = mel[None, :, :, None]
        face = item["spk"][None]
        v.append(np.asarray(syncnet_aud(mel)).mean(axis=1)[0])
        f.append(np.asarray(syncnet_vid(face))[0])
    return np.stack(v), np.stack(f)


def syncnet_embedders(model):
    """(vid, aud) numpy callables over ``model``'s two streams on its device:
    faces (B, 224, 224, 3) -> (B, D); mels in the JAX layout
    (B, n_mels, T, 1) -> (B, T', D)."""
    import torch

    dev = next(model.parameters()).device

    @torch.inference_mode()
    def vid(face):
        return model.forward_vid(torch.as_tensor(np.asarray(face, np.float32),
                                                 device=dev)).cpu().numpy()

    @torch.inference_mode()
    def aud(mel):
        m = torch.as_tensor(np.asarray(mel, np.float32), device=dev).permute(0, 3, 1, 2)
        return model.forward_aud(m).cpu().numpy()

    return vid, aud


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    n_way = int(overrides.pop("n_way", 5))
    n_trials = int(overrides.pop("n_trials", 100))
    bandpass = str(overrides.pop("bandpass", "0")) == "1"
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)

    from facegantts_tpu_torch.data import SyntheticDataset, load_packed
    from facegantts_tpu_torch.evaluation.evaluate import load_syncnet

    ds = load_packed(cfg, "test") or SyntheticDataset(64, cfg.n_mels)
    model, provenance = load_syncnet(cfg, device)
    if provenance is None:
        print("[WARN] no syncnet_ckpt — random embedder, accuracy ~ chance")
    vid, aud = syncnet_embedders(model)
    v, f = embed_dataset(ds, vid, aud)
    results = retrieval_accuracy(v, f, n_way, n_trials, cfg.seed)
    for k, val in results.items():
        print(f"{k}: {val:.4f}")
    out = {"results": results}

    if bandpass:
        band = (cfg.sample_rate, cfg.n_mels, cfg.f_min, cfg.f_max)
        v, f = embed_dataset(ds, vid, aud, band=band)
        results = retrieval_accuracy(v, f, n_way, n_trials, cfg.seed)
        print("-- band-pass 300-4000 Hz sanity check --")
        for k, val in results.items():
            print(f"bandpass/{k}: {val:.4f}")
        out["bandpass"] = results
    return out


if __name__ == "__main__":
    main()

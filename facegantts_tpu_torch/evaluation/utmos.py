"""MOS prediction (reference evaluation/eval.py:209-211,261).

The reference pulls the UTMOS22 "strong learner" off torch.hub
(`tarepan/SpeechMOS`) and reports its predicted MOS alongside the composite
metric (excluded from the composite, eval.py:261).  That model is an SSL
(wav2vec2) feature extractor plus a small regression head — weights live on
an external hub and cannot be assumed present on an air-gapped machine.

A copy of the JAX package's module, which the port keeps because it imports
nothing of that package.  It keeps the same reporting surface with two
backends:

1. ``DSPMOSPredictor`` (default, dependency-free): an interpretable
   signal-quality score built from the acoustic correlates MOS predictors
   learn — spectral clarity (harmonic band SNR), clipping rate, spectral
   flatness of the noise floor, silence ratio, and bandwidth occupancy —
   mapped through a fixed calibration to the 1-5 MOS scale.  Deterministic,
   monotone in each degradation, and useful as a *relative* quality signal
   for regression tracking in CI and in-training eval (the role UTMOS plays
   in the reference's eval_output.txt).
2. ``load_torch_mos_head`` : if the operator ships a UTMOS-style checkpoint
   (any torch state_dict ending in a linear head over time-pooled features),
   the head is imported and applied over this module's frame features,
   replacing the fixed calibration.

Scores are reported under the same ``UTMOS`` key the reference writes so
downstream regex parsers (custom_callbacks.py:13-55) keep working.

``make_mos_predictor`` prefers a third backend over both: the UTMOS-strong
SSL model itself (``evaluation/ssl_mos.py`` with ``models/wav2vec2.py``),
when the checkpoint is one.
"""

from typing import Dict, Optional

import numpy as np

from facegantts_tpu_torch.evaluation.metrics import stft_mag


# ---------------------------------------------------------------------------
# frame-level features
# ---------------------------------------------------------------------------

def mos_features(wav: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 160) -> Dict[str, float]:
    """Utterance-level acoustic quality features in [0, 1]-ish ranges.

    All features increase with *degradation* except ``bandwidth`` and
    ``clarity`` which increase with quality."""
    wav = np.asarray(wav, np.float64)
    if len(wav) == 0:
        return {"clarity": 0.0, "clipping": 1.0, "flatness": 1.0,
                "silence": 1.0, "bandwidth": 0.0}
    peak = np.max(np.abs(wav)) + 1e-12
    wav = wav / peak

    mag = stft_mag(wav, n_fft, hop)  # (T, bins)
    power = mag**2 + 1e-12
    frame_db = 10.0 * np.log10(power.sum(axis=1))
    active = frame_db > (frame_db.max() - 40.0)  # 40 dB activity threshold
    silence = 1.0 - float(active.mean())

    # clipping: fraction of samples within 0.1% of full scale
    clipping = float(np.mean(np.abs(wav) > 0.999))

    # spectral flatness on *active* frames: geometric/arithmetic mean ratio.
    # Clean speech is strongly peaked (low flatness); broadband noise -> 1.
    act = power[active] if active.any() else power
    flat = np.exp(np.mean(np.log(act), axis=1)) / np.mean(act, axis=1)
    flatness = float(np.mean(flat))

    # clarity: energy ratio of the speech band (80 Hz - 4 kHz) vs the rest,
    # on active frames, compressed to [0, 1]
    freqs = np.linspace(0.0, sr / 2.0, mag.shape[1])
    band = (freqs >= 80.0) & (freqs <= 4000.0)
    in_band = act[:, band].sum()
    out_band = act[:, ~band].sum() + 1e-12
    snr_db = 10.0 * np.log10(in_band / out_band + 1e-12)
    clarity = float(np.clip(snr_db / 30.0, 0.0, 1.0))

    # bandwidth occupancy: highest frequency bin holding >= -50 dB of the
    # per-utterance peak bin energy, as a fraction of 8 kHz
    spec = act.mean(axis=0)
    thresh = spec.max() * 1e-5
    occupied = np.where(spec > thresh)[0]
    bw = freqs[occupied[-1]] if len(occupied) else 0.0
    bandwidth = float(np.clip(bw / min(8000.0, sr / 2.0), 0.0, 1.0))

    return {"clarity": clarity, "clipping": clipping, "flatness": flatness,
            "silence": silence, "bandwidth": bandwidth}


# ---------------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------------

class DSPMOSPredictor:
    """Fixed-calibration MOS proxy over :func:`mos_features`.

    The calibration maps perfect features to ~4.5 and saturating
    degradations down to 1.0 (the MOS floor), with weights chosen so each
    degradation alone can cost at most its weight in MOS points."""

    #           feature      weight  (MOS points lost at worst case)
    WEIGHTS = {"clarity": 1.2, "clipping": 1.0, "flatness": 1.5,
               "silence": 0.5, "bandwidth": 0.8}
    CEILING = 4.5

    def __call__(self, wav: np.ndarray, sr: int) -> float:
        f = mos_features(wav, sr)
        penalty = (
            self.WEIGHTS["clarity"] * (1.0 - f["clarity"])
            + self.WEIGHTS["clipping"] * np.clip(f["clipping"] * 50.0, 0.0, 1.0)
            + self.WEIGHTS["flatness"] * np.clip(f["flatness"] * 2.0, 0.0, 1.0)
            + self.WEIGHTS["silence"] * f["silence"]
            + self.WEIGHTS["bandwidth"] * (1.0 - f["bandwidth"])
        )
        return float(np.clip(self.CEILING - penalty, 1.0, 5.0))


class LinearHeadMOSPredictor:
    """MOS = w . features + b with an imported torch linear head."""

    FEATURE_ORDER = ("clarity", "clipping", "flatness", "silence", "bandwidth")

    def __init__(self, weight: np.ndarray, bias: float):
        self.weight = np.asarray(weight, np.float64).reshape(-1)
        assert self.weight.shape[0] == len(self.FEATURE_ORDER), (
            f"head expects {len(self.FEATURE_ORDER)} features, got {self.weight.shape}"
        )
        self.bias = float(bias)

    def __call__(self, wav: np.ndarray, sr: int) -> float:
        f = mos_features(wav, sr)
        x = np.array([f[k] for k in self.FEATURE_ORDER])
        return float(np.clip(self.weight @ x + self.bias, 1.0, 5.0))


def load_torch_mos_head(ckpt_path: str) -> LinearHeadMOSPredictor:
    """Import a torch state_dict containing a final linear regression head.

    Matching is explicit, not first-hit: a documented ``head.weight`` /
    ``head.bias`` pair wins; otherwise the LAST ``*.weight``/``*.bias``
    pair whose weight has the head's expected (1, n_features) or
    (n_features,) shape is used (in a real MOS checkpoint the regression
    head is the final layer; an early SSL layer would be silently wrong).
    ``weights_only=True`` — a checkpoint path is operator input and must
    not execute pickled code."""
    import torch

    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]

    def to_np(t):
        return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)

    n_feat = len(LinearHeadMOSPredictor.FEATURE_ORDER)
    candidates = []
    for k in sd:
        if not k.endswith("weight") or k[:-6] + "bias" not in sd:
            continue
        w = to_np(sd[k])
        if w.size != n_feat:  # only the documented 5-feature head fits
            continue
        candidates.append(k)
    if not candidates:
        raise ValueError(
            f"no ({n_feat},)-shaped linear head found in {ckpt_path}; "
            "export the regression head as 'head.weight'/'head.bias'"
        )
    named = [k for k in candidates if k in ("head.weight", "weight")]
    key = named[0] if named else candidates[-1]
    w = to_np(sd[key])
    b = to_np(sd[key[:-6] + "bias"])
    b = b.item() if b.size == 1 else float(b.reshape(-1)[0])
    return LinearHeadMOSPredictor(w, b)


def make_mos_predictor(ckpt_path: Optional[str] = None, device=None):
    """Factory, in the JAX package's order of fidelity:

    1. a full UTMOS-strong/wav2vec2 SSL checkpoint -> the real architecture
       (evaluation/ssl_mos.py) on ``device`` (the GPU unless the caller asks
       for the CPU), reproducing reference UTMOS scores;
    2. a bare linear regression head -> LinearHeadMOSPredictor over the DSP
       features;
    3. nothing/unloadable -> the DSP calibration proxy (mirrors the
       reference's graceful degradation when torch.hub is unreachable).

    As in JAX, a file that cannot be read or imported falls through to the
    next backend.  The SSL model is built and moved to ``device`` outside
    that fallback: a fault there (no GPU, a key the file lacks) raises."""
    if ckpt_path:
        import torch

        from facegantts_tpu_torch.evaluation import ssl_mos

        imported = None
        try:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            if ssl_mos.looks_like_ssl_checkpoint(sd):
                state, info = ssl_mos.import_utmos_strong(sd)
                ssl_mos.model_sizes(state)  # unsizable -> next backend, as in JAX
                if info["unmapped"]:
                    print(f"[WARN] UTMOS import: {len(info['unmapped'])} "
                          "torch keys unmapped (first: "
                          f"{info['unmapped'][:3]})")
                imported = state
        except Exception as e:
            print(f"[WARN] SSL MOS import failed ({e}); trying linear head")
        if imported is not None:
            return ssl_mos.SSLMOSPredictor(ssl_mos.model_from_state_dict(imported, device=device))
        try:
            return load_torch_mos_head(ckpt_path)
        except Exception as e:  # missing/foreign ckpt -> proxy
            print(f"[WARN] MOS head import failed ({e}); using DSP proxy")
    return DSPMOSPredictor()

"""Objective evaluation CLI of the PyTorch port (reference
evaluation/eval.py:123-279).

Port of the JAX package's ``evaluation/evaluate.py``: pairs generated and
ground-truth wavs by relative path, computes speaker similarity / log-F0
RMSE / MCD / LSD and the normalized composite, and writes
`eval_output.txt` in the exact key:value format the reference's callbacks
and hyperopt harness parse.  The mels (the port's mel op) and SyncNet run
on the card unless ``device=cpu``; the other metrics are the host's numpy.

Usage:
  python -m facegantts_tpu_torch.evaluation.evaluate output_dir=<gen_wavs> \
      ground_truth_dir=<gt_wavs> [results_path=evaluation] [syncnet_ckpt=...] \
      [device=cpu]
"""

import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from facegantts_tpu_torch.config import Config, default_config, parse_cli_overrides
from facegantts_tpu_torch.evaluation import metrics as M
from facegantts_tpu_torch.synthesis import resolve_device
from facegantts_tpu_torch.utils.audio import load_wav


def find_wavs(root: str) -> List[str]:
    out = []
    for base, _, files in os.walk(root):
        out += [os.path.join(base, f) for f in files if f.endswith(".wav")]
    return sorted(out)


def _mel(wav: np.ndarray, cfg: Config, device=None) -> np.ndarray:
    """(T,) waveform -> (n_mels, frames) log-mel by the port's mel op on
    ``device`` (the card unless the caller asks for the CPU)."""
    from facegantts_tpu_torch.ops.mel import mel_spectrogram

    y = torch.as_tensor(np.asarray(wav, np.float32)[None], device=resolve_device(device))
    return mel_spectrogram(
        y, cfg.n_fft, cfg.n_mels, cfg.sample_rate, cfg.hop_len,
        cfg.win_len, cfg.f_min, cfg.f_max,
    )[0].cpu().numpy()


def load_syncnet(cfg: Config, device=None):
    """The full-width SyncNet of ``cfg`` on ``device`` in eval mode, and its
    provenance: ``cfg.syncnet_ckpt`` (a reference torch file, the one the JAX
    package's ``import_syncnet_checkpoint`` reads) when it exists, else
    random weights from seed 0.  Returns (model, provenance or None)."""
    from facegantts_tpu_torch.models.syncnet import SyncNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SyncNet(n_out=cfg.vid_emb_dim, stride=cfg.syncnet_stride)
    provenance = None
    if cfg.syncnet_ckpt and os.path.exists(cfg.syncnet_ckpt):
        from facegantts_tpu_torch.train.checkpoint import load_syncnet_state_dict

        missing, _ = model.load_state_dict(load_syncnet_state_dict(cfg.syncnet_ckpt),
                                           strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"syncnet_ckpt {cfg.syncnet_ckpt}: no {missing[:4]} ...")
        provenance = f"pretrained ({cfg.syncnet_ckpt})"
    return model.eval().to(resolve_device(device)), provenance


def build_syncnet_apply(cfg: Config, device=None):
    """SyncNet forward_aud as a plain callable, numpy (B, n_mels, T, 1) mel
    -> numpy (B, T', D), on ``device`` (random init if no ckpt — similarity
    numbers are then only self-consistent, like the reference without its
    pretrained syncnet).  The chosen backend is recorded in
    ``apply.provenance`` so eval outputs can state it loudly."""
    model, provenance = load_syncnet(cfg, device)
    if provenance is None:
        provenance = ("RANDOM-INIT — Speaker Similarity is self-consistent "
                      "only; set syncnet_ckpt for reference-comparable values")
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def apply(mel):
        m = torch.as_tensor(np.asarray(mel, np.float32), device=dev).permute(0, 3, 1, 2)
        return model.forward_aud(m).cpu().numpy()

    apply.provenance = provenance
    apply.device = dev
    return apply


def backend_provenance(cfg: Config, syncnet_apply, mos) -> List[str]:
    """Human-readable lines naming which metric backends are REAL pretrained
    models vs documented fallbacks, stamped into eval_output.txt and the
    in-train eval JSONL: a composite produced with a random-init SyncNet or
    the DSP MOS proxy must say so loudly, so numbers are never misread as
    reference-comparable."""
    sync_p = getattr(syncnet_apply, "provenance",
                     "unknown (custom syncnet_apply)")
    mos_cls = type(mos).__name__
    if mos_cls == "SSLMOSPredictor":
        mos_p = f"utmos-ssl checkpoint ({cfg.mos_ckpt})"
    elif mos_cls == "LinearHeadMOSPredictor":
        mos_p = f"linear regression head ({cfg.mos_ckpt}) over DSP features"
    else:
        mos_p = ("DSP calibration proxy — UTMOS column is NOT the real "
                 "utmos22_strong predictor; set mos_ckpt for parity")
    f0_p = {
        "world": "world (dio+stonemask+fastdtw — the reference eval protocol)",
        "pyin": "pyin (HMM-smoothed probabilistic YIN, reference C10 protocol)",
    }.get(cfg.f0_protocol, f"{cfg.f0_protocol} (fast estimator)")
    return [
        f"# backend syncnet: {sync_p}",
        f"# backend mos: {mos_p}",
        f"# backend f0: {f0_p}",
    ]


def score_wav_pair(gen: np.ndarray, ref: np.ndarray, cfg: Config,
                   syncnet_apply, mos, device=None) -> Dict[str, float]:
    """Score ONE (generated, ground-truth) waveform pair with the full
    offline protocol (reference eval.py:186-218): SyncNet speaker similarity
    on mels, log-F0 RMSE per ``cfg.f0_protocol``, MCD, LSD, predicted MOS.
    The mels are computed on ``device``, by default the SyncNet's.

    Shared by the offline CLI (:func:`evaluate_pairs`) and the in-training
    evaluator (evaluation/intrain.py), so checkpoint ranking mid-training
    uses the SAME metric definitions as the reference's eval subprocess
    (custom_callbacks.py:57-92 runs evaluation/eval.py in-train)."""
    device = device if device is not None else getattr(syncnet_apply, "device", None)
    _, sim = M.speaker_similarity(syncnet_apply, _mel(ref, cfg, device),
                                  _mel(gen, cfg, device))
    if cfg.f0_protocol == "world":
        # reference protocol: dio+stonemask F0, fastdtw on mel-cepstra
        # (eval.py:49-79) — absolute values comparable with reference
        from facegantts_tpu_torch.evaluation import world

        f0 = world.world_log_f0_rmse(ref, gen, cfg.sample_rate)
    elif cfg.f0_protocol == "pyin":
        # the reference's *extractor* protocol (C10, librosa.pyin via
        # evaluation/pyin.py) with the repo's DTW alignment
        f0 = M.log_f0_rmse(ref, gen, cfg.sample_rate, estimator="pyin")
    else:  # "yin": faster estimator, same alignment structure
        f0 = M.log_f0_rmse(ref, gen, cfg.sample_rate)
    return {
        "sim": float(sim),
        "f0": float(f0),
        "mcd": float(M.mcd(ref, gen, cfg.sample_rate)),
        "lsd": float(M.log_spectral_distance(ref, gen, cfg.n_fft, cfg.hop_len)),
        "mos": float(mos(gen, cfg.sample_rate)),
    }


def evaluate_pairs(
    gen_dir: str, gt_dir: str, cfg: Config, max_files: Optional[int] = None,
    header_out: Optional[List[str]] = None, device=None,
) -> Dict[str, float]:
    """Score every paired wav under gen_dir/gt_dir.  When ``header_out`` is
    given, the backend-provenance lines are appended to it (for stamping
    into eval_output.txt)."""
    from facegantts_tpu_torch.evaluation.utmos import make_mos_predictor

    gen_wavs = find_wavs(gen_dir)
    if max_files:
        gen_wavs = gen_wavs[:max_files]
    syncnet_apply = build_syncnet_apply(cfg, device)
    mos = make_mos_predictor(cfg.mos_ckpt, device)
    provenance = backend_provenance(cfg, syncnet_apply, mos)
    for line in provenance:
        print(line)
    if header_out is not None:
        header_out.extend(provenance)

    sims, f0s, mcds, lsds, moses = [], [], [], [], []
    n_paired = 0
    for gw in gen_wavs:
        rel = os.path.relpath(gw, gen_dir)
        gt = os.path.join(gt_dir, rel)
        if not os.path.exists(gt):
            continue
        n_paired += 1
        gen, sr_g = load_wav(gw)
        ref, sr_r = load_wav(gt)
        s = score_wav_pair(gen, ref, cfg, syncnet_apply, mos)
        sims.append(s["sim"])
        f0s.append(s["f0"])
        mcds.append(s["mcd"])
        lsds.append(s["lsd"])
        moses.append(s["mos"])

    if n_paired == 0:
        raise SystemExit(f"no paired wavs between {gen_dir} and {gt_dir}")

    mean = lambda v: float(np.mean(v))  # noqa: E731
    results = {
        "Composite Metric": M.composite_metric(
            mean(sims), mean(f0s), mean(mcds), mean(lsds)
        ),
        "Speaker Similarity": mean(sims),
        "F0 RMSE": mean(f0s),
        "MCD": mean(mcds),
        "STFT Distance": mean(lsds),
        # reported but excluded from the composite (reference eval.py:261)
        "UTMOS": mean(moses),
        "Paired Files": float(n_paired),
    }
    return results


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    max_files = overrides.pop("max_files", None)
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)
    header: List[str] = []
    results = evaluate_pairs(
        cfg.output_dir, cfg.ground_truth_dir, cfg,
        int(max_files) if max_files else None,
        header_out=header, device=device,
    )
    print("######## Evaluation Results ########")
    text = M.format_eval_output(results)
    print(text)
    out_dir = os.getenv("DYNAMIC_EVAL_PATH", cfg.results_path)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval_output.txt"), "w") as f:
        # provenance header first — comment lines the reference-format
        # regex parsers (Composite Metric: <float>) skip over
        f.write("".join(line + "\n" for line in header))
        f.write(text)
    return results


if __name__ == "__main__":
    main()

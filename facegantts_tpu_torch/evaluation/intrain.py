"""In-training periodic evaluation of the PyTorch port (reference
StepwiseEvalCallback, custom_callbacks.py:57-92,165-190 — minus the
subprocess hack).

Port of the JAX package's ``evaluation/intrain.py``.  Every
``cfg.eval_interval`` steps the trainer calls :meth:`IntrainEvaluator.run`
with the live TrainState: a few validation items are synthesized end-to-end
(10-step diffusion + HiFi-GAN, on the trainer's device) with the *current*
generator weights, and

- the full offline protocol against the copy-synthesized ground truth
  (SyncNet speaker similarity, F0 RMSE, MCD, LSD, MOS, the composite) and
  the mel distance to the ground-truth mel are written to
  ``<dir>/step_<step>/eval_output.txt`` in the reference's regex-parsed
  ``key: value`` format (custom_callbacks.py:13-55), under the same
  backend-provenance lines as the JAX package,
- wavs land next to it (``sample_<i>.wav``), and the caller's MetricLogger
  publishes the scalars (and the audio when TensorBoard is available),

all in-process.
"""

import os
from typing import Dict, Optional

import numpy as np

from facegantts_tpu_torch.config import Config
from facegantts_tpu_torch.evaluation import metrics as M
from facegantts_tpu_torch.evaluation.utmos import make_mos_predictor


def load_eval_vocoder_params(cfg: Config):
    """The pretrained HiFi-GAN weights that ``cfg.vocoder_ckpt`` names, as the
    port's vocoder ``state_dict`` (reference pulls bshall/hifigan via
    torch.hub, inference.py:79).  Returns None (-> random init, mel metrics
    only) when unset or unreadable — with a loud warning, because wavs
    vocoded with random weights are noise."""
    if not cfg.vocoder_ckpt:
        print("[WARN] intrain eval: cfg.vocoder_ckpt unset — vocoded wavs/"
              "UTMOS use a RANDOM vocoder; only mel metrics are meaningful")
        return None
    try:
        from facegantts_tpu_torch.train.checkpoint import load_hifigan_state_dict

        return load_hifigan_state_dict(cfg.vocoder_ckpt)
    except Exception as e:  # missing/corrupt file: degrade, don't kill train
        print(f"[WARN] intrain eval: failed to import vocoder_ckpt "
              f"{cfg.vocoder_ckpt!r} ({e}); falling back to random vocoder")
        return None


class IntrainEvaluator:
    """Reusable in-training evaluator: builds the Synthesizer, SyncNet
    scorer, MOS predictor, and (imported) vocoder ONCE on ``device`` (the
    card unless the caller asks for the CPU), then re-scores the live
    generator weights each eval interval."""

    def __init__(self, cfg: Config, val_ds, out_dir: str,
                 vocoder_params=None, syncnet_apply=None, device=None):
        from facegantts_tpu_torch.evaluation.evaluate import (
            backend_provenance,
            build_syncnet_apply,
        )
        from facegantts_tpu_torch.synthesis import Synthesizer

        self.cfg = cfg
        self.val_ds = val_ds
        self.out_dir = out_dir
        if vocoder_params is None:
            vocoder_params = load_eval_vocoder_params(cfg)
        self.vocoder_imported = vocoder_params is not None
        self.synth = Synthesizer(cfg, vocoder_state_dict=vocoder_params, device=device)
        self.syncnet_apply = (
            syncnet_apply if syncnet_apply is not None
            else build_syncnet_apply(cfg, self.synth.device)
        )
        self.mos = make_mos_predictor(cfg.mos_ckpt, self.synth.device)
        # every in-train eval_output.txt says which backends were real
        # pretrained models vs fallbacks, plus whether the vocoder was imported
        self.provenance = backend_provenance(cfg, self.syncnet_apply, self.mos)
        self.provenance.append(
            "# backend vocoder: "
            + (f"imported ({cfg.vocoder_ckpt})" if self.vocoder_imported
               else "RANDOM-INIT — vocoded wavs/UTMOS are noise; only "
                    "mel metrics are meaningful")
        )
        for line in self.provenance:
            print("[intrain eval]", line)

    def _gt_wav(self, gt_mel: np.ndarray) -> np.ndarray:
        """Ground-truth reference waveform by COPY-SYNTHESIS: vocode the GT
        mel with the same HiFi-GAN used for the generated sample.  The packed
        dataset stores mels, not waveforms; passing both sides through the
        same vocoder makes the waveform-domain metrics (F0 RMSE, MCD, LSD)
        measure the TTS model alone, exactly as the reference's eval compares
        vocoded outputs to studio wavs modulo its shared-vocoder bias
        (reference evaluation/eval.py:186-218)."""
        return np.concatenate(list(self.synth.stream_vocode(gt_mel)))

    def run(self, state, step: int) -> Dict[str, float]:
        """Synthesize n validation items with the current weights of
        ``state.model`` and score them with the FULL offline protocol
        (speaker-sim, F0 RMSE, MCD, LSD, MOS, composite — the same
        `score_wav_pair` the offline CLI uses), so checkpoint ranking
        mid-training matches the reference's StepwiseEval semantics
        (custom_callbacks.py:57-92 runs the real eval subprocess;
        eval.py:229-253 defines the composite).  Also keeps the cheap
        mel-domain distance for continuity.  Returns the metric dict (also
        written to eval_output.txt in the reference's key: value format)."""
        from facegantts_tpu_torch.evaluation.evaluate import score_wav_pair
        from facegantts_tpu_torch.utils.audio import save_wav

        cfg = self.cfg
        self.synth.update_params(state_dict=state.model.state_dict())
        step_dir = os.path.join(self.out_dir, f"step_{step:08d}")
        os.makedirs(step_dir, exist_ok=True)

        sims, f0s, mcds, lsds, moses, mel_ds = [], [], [], [], [], []
        for i in range(min(cfg.eval_n_samples, len(self.val_ds))):
            item = self.val_ds[i]
            face = self.synth.prepare_face(item["spk"])
            wav, mel = self.synth.synthesize(item["x"], face, seed=i)
            gt_mel = np.asarray(item["y"], np.float32)
            s = score_wav_pair(wav, self._gt_wav(gt_mel), cfg,
                               self.syncnet_apply, self.mos, device=self.synth.device)
            sims.append(s["sim"])
            f0s.append(s["f0"])
            mcds.append(s["mcd"])
            lsds.append(s["lsd"])
            moses.append(s["mos"])
            t = min(mel.shape[1], gt_mel.shape[1])
            mel_ds.append(float(np.mean(np.sqrt(np.mean(
                (mel[:, :t] - gt_mel[:, :t]) ** 2, axis=0)))))
            save_wav(os.path.join(step_dir, f"sample_{i}.wav"), wav, cfg.sample_rate)

        mean = lambda v: float(np.mean(v)) if v else 0.0  # noqa: E731
        results = {
            # same keys as evaluation/evaluate.py (offline CLI) — the
            # composite is what CheckpointPolicy can monitor
            "Composite Metric": M.composite_metric(
                mean(sims), mean(f0s), mean(mcds), mean(lsds)
            ) if sims else 0.0,
            "Speaker Similarity": mean(sims),
            "F0 RMSE": mean(f0s),
            "MCD": mean(mcds),
            "STFT Distance": mean(lsds),
            "UTMOS": mean(moses),
            # extra (not part of the reference protocol): mel-domain LSD of
            # the model output vs the GT mel, vocoder-independent
            "Mel Distance": mean(mel_ds),
            "Samples": float(len(sims)),
        }
        with open(os.path.join(step_dir, "eval_output.txt"), "w") as f:
            f.write("".join(line + "\n" for line in self.provenance))
            f.write(M.format_eval_output(results))
        return results


def run_intrain_eval(
    cfg: Config,
    state,
    val_ds,
    out_dir: str,
    step: int,
    vocoder_params=None,
    syncnet_apply=None,
    n_samples: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """One-shot wrapper around :class:`IntrainEvaluator` (kept for callers
    that eval a single checkpoint; the training loop holds an evaluator)."""
    if n_samples is not None:
        cfg = cfg.replace(eval_n_samples=n_samples)
    ev = IntrainEvaluator(cfg, val_ds, out_dir,
                          vocoder_params=vocoder_params,
                          syncnet_apply=syncnet_apply, device=device)
    return ev.run(state, step)

"""Synthesis entry point of the PyTorch port (the root ``inference.py``'s
counterpart).

    python -m facegantts_tpu_torch.inference key=value ...

Modes (``use_custom``, reference config.py:154-158):
  1 -- custom face image (``test_faceimg``) + sentences from ``test_txt``
  2 -- the LRS2 test split (``lrs2_path/test``) with a fixed face, then the
       ``test_txt`` sentences; without the split only the sentences run
  other -- the face of the first clip of the packed test split (else the
       val split) under ``packed_data_dir`` + the ``test_txt`` sentences,
       written as ``{FACE_TAG}_sample_{i}.wav``; without a packed split,
       with a warning, the face of ``test_faceimg``

Weights: ``resume_from=`` a port checkpoint directory (its newest step) or
a reference FaceTTS ``.pt``/``.ckpt`` (GAN keys stripped, loaded by name and
shape into a model initialised from seed 0), ``vocoder_ckpt=`` a bshall
HiFi-GAN-16k file (weight norm folded); without them both models keep their
random initialisation from seed 0.  A path that does not exist raises.  The
run goes through the whole pipeline on the GPU (``device=cpu`` runs it on
the CPU).
"""

import os
import sys

from facegantts_tpu_torch.config import default_config, parse_cli_overrides


def load_weights(cfg):
    """(generator state_dict, vocoder state_dict) that ``resume_from`` and
    ``vocoder_ckpt`` name, each None when its key is empty."""
    from facegantts_tpu_torch.train import checkpoint as ck

    state_dict = vocoder_state_dict = None
    if cfg.resume_from:
        print(f"######## Loading checkpoint from {cfg.resume_from}")
        state_dict = ck.generator_state_dict(cfg, cfg.resume_from)
    if cfg.vocoder_ckpt:
        vocoder_state_dict = ck.load_hifigan_state_dict(cfg.vocoder_ckpt)
    return state_dict, vocoder_state_dict


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)

    from facegantts_tpu_torch.synthesis import Synthesizer, load_face, resolve_device
    from facegantts_tpu_torch.text.cmudict import default_cmudict
    from facegantts_tpu_torch.utils.audio import save_wav

    resolve_device(device)  # no card: raise before reading any weights
    state_dict, vocoder_state_dict = load_weights(cfg)
    synth = Synthesizer(cfg, state_dict=state_dict, vocoder_state_dict=vocoder_state_dict,
                        cmudict=default_cmudict(cfg.cmudict_path), device=device)
    out_dir = cfg.output_dir
    os.makedirs(out_dir, exist_ok=True)

    if cfg.use_custom == 2:
        test_dir = os.path.join(cfg.lrs2_path, "test")
        if os.path.isdir(test_dir):
            face = load_face(cfg.test_faceimg, cfg.image_size)
            for speaker in sorted(os.listdir(test_dir))[:5]:
                sdir = os.path.join(test_dir, speaker)
                for fn in sorted(os.listdir(sdir)):
                    if not fn.endswith(".txt"):
                        continue
                    with open(os.path.join(sdir, fn)) as f:
                        line = f.readline().strip()
                    text = (line.split(":", 1)[1].strip()
                            if line.upper().startswith("TEXT") else line)
                    wav, _ = synth.synthesize(text, face)
                    odir = os.path.join(out_dir, speaker)
                    os.makedirs(odir, exist_ok=True)
                    out = os.path.join(odir, fn.replace(".txt", ".wav"))
                    save_wav(out, wav, cfg.sample_rate)
                    print(f"Saved  ->  {out}")
        else:
            print(f"[WARN] {test_dir} not found; falling back to test_txt sentences")

    # mode "other": the face of the first packed clip (JAX inference.py:72-83)
    face = None
    if cfg.use_custom not in (1, 2):
        from facegantts_tpu_torch.data.dataset import load_packed

        ds = load_packed(cfg, "test") or load_packed(cfg, "val")
        if ds is not None and len(ds):
            face = ds[0]["spk"]  # (224, 224, 3) float32 BGR 0..255
            print("######## Using the first dataset clip's face")
        else:
            print("[WARN] no packed dataset for a dataset face; falling back to test_faceimg")
    if face is None:
        face = load_face(cfg.test_faceimg, cfg.image_size)
    if os.path.exists(cfg.test_txt):
        with open(cfg.test_txt) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
        tag = os.environ.get("FACE_TAG", "face")
        for i, text in enumerate(texts):
            wav, _ = synth.synthesize(text, face)
            out = os.path.join(out_dir, f"{tag}_sample_{i}.wav")
            save_wav(out, wav, cfg.sample_rate)
            print(f"Saved  ->  {out}  ({len(wav) / cfg.sample_rate:.2f}s)")
    print(f"######## Done inference. Check '{out_dir}' folder")


if __name__ == "__main__":
    main()

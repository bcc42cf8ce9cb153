"""Training entry point of the PyTorch port (the root ``train.py``'s
counterpart).

    python -m facegantts_tpu_torch.train use_gan=0 max_steps=N [key=value ...] [device=cpu]

Every Config key works as an override (environment variables and
``config=<file.json>`` too).  Runs the plain FaceTTS step on the GPU unless
``device=cpu``; ``work_dir=`` (default ``runs/default``) receives
``metrics.jsonl``.  ``use_gan=1``, the Config default, raises until the GAN
slice is ported.
"""

import sys

from facegantts_tpu_torch.config import default_config, parse_cli_overrides


def main(argv=None):
    overrides = parse_cli_overrides(argv if argv is not None else sys.argv[1:])
    work_dir = overrides.pop("work_dir", "runs/default")
    device = overrides.pop("device", None)
    cfg = default_config(overrides=overrides)
    print(f"[INFO] use_gan={cfg.use_gan} batch_size={cfg.batch_size} "
          f"max_steps={cfg.max_steps} work_dir={work_dir} device={device or 'cuda'}")
    from facegantts_tpu_torch.train.loop import train

    train(cfg, work_dir=work_dir, device=device)


if __name__ == "__main__":
    main()

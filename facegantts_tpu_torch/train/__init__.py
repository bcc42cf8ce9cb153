"""Training of the PyTorch port: the plain (no-GAN) FaceTTS step and loop."""

from facegantts_tpu_torch.train.state import Batch, TrainState  # noqa: F401

"""Training of the PyTorch port: the plain FaceTTS step, the GAN step and the loop."""

from facegantts_tpu_torch.train.state import Batch, TrainState  # noqa: F401

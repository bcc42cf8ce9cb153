from facegantts_tpu_torch.models.diffusion import Diffusion  # noqa: F401
from facegantts_tpu_torch.models.discriminator import SpectrogramDiscriminator  # noqa: F401
from facegantts_tpu_torch.models.facetts import FaceTTS  # noqa: F401
from facegantts_tpu_torch.models.hifigan import HiFiGANGenerator  # noqa: F401
from facegantts_tpu_torch.models.syncnet import SyncNet  # noqa: F401
from facegantts_tpu_torch.models.text_encoder import TextEncoder  # noqa: F401
from facegantts_tpu_torch.models.unet import GradLogPEstimator2d  # noqa: F401

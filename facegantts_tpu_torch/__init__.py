"""face-gan-tts, PyTorch/CUDA port.

A port of the JAX package ``facegantts_tpu`` to PyTorch on NVIDIA GPUs,
slice by slice; this package holds the inference slice (text + face ->
16 kHz waveform) and the plain (no-GAN) training slice (``train/``).
Module paths mirror the JAX package.  Plain tensor code is PyTorch; the JAX
package's Pallas TPU kernels become hand-written CUDA kernels (``csrc/``),
each beside its plain torch version.  The package imports neither JAX nor
the JAX package.
"""

__version__ = "0.2.0"

from facegantts_tpu_torch.config import Config, default_config  # noqa: F401

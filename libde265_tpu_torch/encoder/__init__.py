"""Copy of libde265_tpu/encoder/__init__.py (the port keeps its own
copies of the host modules and imports nothing of the JAX package).

Encoder subsystem (en265-equivalent capability)."""
from .encoder import Encoder, EncoderConfig

"""slamem_tpu_torch — the PyTorch + CUDA port of slamem_tpu, the
maximal-exact-match (MEM) finder.

The JAX package ``slamem_tpu`` is the reference; this package imports
neither it nor JAX. Its layout and public names mirror the reference's
(io/, index/, kernels/, engine/, dist/, report/, cli/); every entry point
takes a ``device`` (the card unless the caller asks for the CPU). The seed
engine (the default) and the scan engine run end to end, on one device or a
mesh of ranks. The only TPU kernel of the reference, the Pallas rank
kernel, is the hand-written CUDA kernel ``kernels/csrc/rank.cu``, beside
the port's other kernels (``kernels/csrc/``).
"""

__version__ = "0.1.0"

from slamem_tpu_torch.config import Config, MatchMode  # noqa: F401,E402

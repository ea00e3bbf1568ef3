"""slamem_tpu_torch — the PyTorch + CUDA port of slamem_tpu, the
maximal-exact-match (MEM) finder.

The JAX package ``slamem_tpu`` is the reference; this package imports
neither it nor JAX. Its layout mirrors the reference's (io/, index/,
kernels/, engine/, report/, cli/), every entry point takes an explicit
device, and the only TPU kernel of the reference, the Pallas rank kernel, is
the hand-written CUDA kernel ``kernels/csrc/rank.cu``. The scan engine
(``Config(engine="scan")``) runs end to end; see ROADMAP.md for the rest.
"""

__version__ = "0.1.0"

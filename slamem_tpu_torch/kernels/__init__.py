"""Hand-written CUDA kernels of the port (``csrc/*.cu``) and their loaders.

Each source is compiled by nvcc for sm_90a at first use into the
git-ignored ``build/`` beside this file (``_native.build_shared``: digest-
named, renamed into place, raises on a failed build) and loaded with ctypes
through plain C entry points. Importing this package builds nothing.
"""

from __future__ import annotations

import os
from pathlib import Path

from slamem_tpu_torch._native import build_shared, find_tool

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).parent / "build"


def build_nvcc(source: Path, stem: str) -> tuple[Path, str]:
    """Build ``source`` with nvcc (PATH, else ``$CUDA_HOME/bin``, default
    /usr/local/cuda) unless built; returns (library path, build log)."""
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    nvcc = find_tool("nvcc", cuda_home / "bin" / "nvcc")
    return build_shared(nvcc, NVCC_FLAGS, source, BUILD_DIR, stem)

"""Host-side C code of the port and the build step shared by every native
library of the package (the CUDA rank kernels included).

A library is compiled at first use, from the source in this package, into a
git-ignored ``build/`` directory beside the source, named by a digest of the
source and the compiler flags. The compiler writes a temporary file that is
renamed into place, so concurrent first uses (test workers, several
processes) never load a half-written library. A failed build raises with
the compiler's output: nothing falls back to another path. Importing this
package builds nothing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

GCC_FLAGS = ("-O3", "-fPIC", "-shared")


def find_tool(name: str, fallback: Path | None = None) -> str:
    """Path of a compiler on PATH (or at ``fallback``); raises if absent."""
    found = shutil.which(name)
    if found:
        return found
    if fallback is not None and fallback.exists():
        return str(fallback)
    raise RuntimeError(f"{name} not found (PATH"
                       f"{', ' + str(fallback) if fallback else ''}): the "
                       "port's native code is built from source at first use")


def build_shared(tool: str, flags: Sequence[str], source: Path,
                 build_dir: Path, stem: str) -> tuple[Path, str]:
    """Compile ``source`` into ``build_dir/lib<stem>_<digest>.so`` unless
    that library exists; returns (path, compiler output of this build)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    path = build_dir / f"lib{stem}_{digest}.so"
    if path.exists():
        return path, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([tool, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(tool).name} failed ({proc.returncode}) on "
                f"{source.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, proc.stdout + proc.stderr


def build_gcc(source: Path, stem: str) -> Path:
    """Build a host C library of this package with gcc (see build_shared)."""
    path, _ = build_shared(find_tool("gcc"), GCC_FLAGS, source,
                           Path(__file__).parent / "build", stem)
    return path

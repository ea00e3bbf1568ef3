"""What a run may not load: JAX, its relatives, and the JAX package the
port was made from. Names compare whole, by their top level, so the
port (``slamem_tpu_torch``) is not the JAX package (``slamem_tpu``)."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "slamem_tpu"})


def forbidden(modules) -> list[str]:
    """The top-level names among ``modules`` (e.g. ``sys.modules``) that a
    run may not hold."""
    return sorted({name.split(".")[0] for name in modules
                   if name.split(".")[0] in FORBIDDEN})

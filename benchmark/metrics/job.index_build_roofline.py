"""Share of the index build's least time, %: the bytes any build of an
index over this reference moves (codes read once; text, SA, BWT, occ
checkpoints at the CLI's spacing of 128 and C[] written once) at the
H100's 3.35 TB/s, over the device's busy time inside the traced
``bench:index_build`` span (kernels, copies and fills), mean per job."""

from benchmark.harness.arith import H100_HBM_BYTES_S, index_bytes

OCC_BLOCK = 128


def read(run):
    build = (run.trace or {}).get("spans", {}).get("bench:index_build")
    if not build or build["device_s"] <= 0:
        return None
    least_s = index_bytes(run.reference_symbols, OCC_BLOCK) / H100_HBM_BYTES_S
    return 100.0 * least_s / (build["device_s"] / build["count"])

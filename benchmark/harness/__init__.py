"""The general parts of the harness: the manifest, the traffic mix, the
arithmetic of the metrics, the trace reduction and the checks."""

"""output_share: per cent of the window spent writing output records
(Timestepper.stats["output_seconds"]: the source and network fields'
evaluation, the device-to-host copies and the HDF5 writes)."""


def read(run):
    return 100.0 * run["stats"].get("output_seconds", 0.0) / run["window_s"]

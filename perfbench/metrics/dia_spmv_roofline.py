"""dia_spmv_roofline: per cent of the band SpMV kernel's roofline over
the traced window: the bytes its launches need (perfbench/lib/spmv.py:
the values of the nonzero blocks, x read once, y written once, for the
dtype that ran, times the port's launch counts) over the published HBM
bandwidth (perfbench/lib/peaks.py), divided by the device time of the
csrc/dia_spmv.cu kernels in the trace. None where none ran."""

from perfbench.lib import peaks, spmv

KERNEL = "dia_spmv_kernel"
DTYPE_IN_NAME = {"float32": "<float,", "float64": "<double,"}


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    sz = run["sizes"]
    need_s = 0.0
    device_s = 0.0
    for dtype, launches in run["launches"].items():
        secs = sum(v for k, v in tr["kernel_s"].items()
                   if KERNEL in k
                   and DTYPE_IN_NAME[dtype] in k.replace(" ", ""))
        if not launches or secs <= 0:
            continue
        nbytes = spmv.band_spmv_bytes(sz["rows"], sz["interior_faces"],
                                      sz["primary_variables"], dtype)
        need_s += launches * nbytes / peaks.HBM_BYTES_PER_S
        device_s += secs
    return 100.0 * need_s / device_s if device_s > 0 else None

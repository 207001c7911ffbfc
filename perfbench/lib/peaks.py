"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor
Core GPU data sheet, dense rates, at the full 700 W power limit): the
yardstick of every roofline share the benchmark reports. A card set
below 700 W runs below these; each run prints its power limit."""

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float64": 34e12, "float32": 67e12}
SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, SXM5: 3.35 TB/s HBM3"

"""The program calls scan_roofline_pct reads: each call of the port's scan
kernel wrappers (K1's ``scan_block``, K2's ``scan_tiled``), written to the
work as ``("scan", op, shape, dtype)``."""

SCAN = "gps_optimize_slam_tpu_torch.ops.scan"


def note(op, x, *rest, **kwargs):
    return ("scan", op, tuple(x.shape), str(x.dtype).split(".")[-1])


RECORDS = [(SCAN, "scan_block", note), (SCAN, "scan_tiled", note)]

"""Share of its bytes roofline that a round's path fetches reach: the bytes
the fetches need (``gvbench.costbytes.kernel_bytes``, from the cell's
sizes) over the card's peak memory bandwidth, divided by the time of the
kernels that fetch and decrypt path rows, whichever implements it."""

from gvbench import costbytes, trace

#: the fused gather-and-decrypt kernels: one CTA a row (the tiled one) and
#: the row ring's gather direction
KERNELS = [r"\bgather_tiled_kernel\(", r"\bring_kernel<\d+, \d+, 1>"]


def read(run: dict):
    tr, peak = run["trace"], run["peak"]
    if not tr or not peak:
        return None
    n, s = trace.kernel_seconds(tr, KERNELS)
    if not n or s <= 0:
        return None
    need = costbytes.kernel_bytes(run["engine"], run["record_size"])["fetch"]
    return 100.0 * need * run["trace_rounds"] / peak["hbm_bytes_per_s"] / s

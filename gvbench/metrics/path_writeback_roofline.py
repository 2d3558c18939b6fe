"""Share of its bytes roofline that a round's path write-backs reach: the
bytes the write-backs need (``gvbench.costbytes.kernel_bytes``, from the
cell's sizes) over the card's peak memory bandwidth, divided by the time
of the kernels that encrypt and scatter path rows, whichever implements it."""

from gvbench import costbytes, trace

#: the row ring's scatter direction, one row or up to eight a step
KERNELS = [r"\bring_kernel<\d+, \d+, 0>"]


def read(run: dict):
    tr, peak = run["trace"], run["peak"]
    if not tr or not peak:
        return None
    n, s = trace.kernel_seconds(tr, KERNELS)
    if not n or s <= 0:
        return None
    need = costbytes.kernel_bytes(run["engine"], run["record_size"])["writeback"]
    return 100.0 * need * run["trace_rounds"] / peak["hbm_bytes_per_s"] / s

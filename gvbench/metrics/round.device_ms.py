"""Kernel milliseconds a steady round launches: every kernel's time in the
traced rounds, summed, over the rounds traced."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["kernel_count"]:
        return None
    return 1e3 * sum(s for _c, s in tr["kernels"].values()) / run["trace_rounds"]

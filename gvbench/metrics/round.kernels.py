"""Kernels a steady round launches, counted in the traced rounds."""


def read(run: dict):
    tr = run["trace"]
    if not tr or not tr["kernel_count"]:
        return None
    return tr["kernel_count"] / run["trace_rounds"]

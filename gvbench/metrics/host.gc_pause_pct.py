"""Share of the window the interpreter spent in garbage collections, timed
by a ``gc.callbacks`` hook the benchmark holds over the window."""


def read(run: dict):
    return 100.0 * run["gc_s"] / run["window_s"] if run["window_s"] > 0 else None

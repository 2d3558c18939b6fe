"""Share of the traced stretch of steady rounds in which no operation ran
on the device: one minus the trace's busy time over the trace's window
(first device operation's start to the last one's end). The profiler costs
the host time at every launch, so these rounds run slower than the
window's and their idle share stands above the window's; the run prints
both round periods (``traced_round_s``, ``window_round_s``)."""


def read(run: dict):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

"""Milliseconds, by the card's own clock, from the stream reaching a window
round's upload to the end of its output copies (``PendingRound.device_span_s``,
two CUDA events the program records around every round), the mean over the
window's rounds, which run with no profiler on. The round's kernel time
plus the time the card waited inside the round; nothing on the CPU."""


def read(run: dict):
    got = [r["device"] for r in run["spans"] if r["device"] is not None]
    if not got or len(got) != len(run["spans"]):
        return None
    return 1e3 * sum(got) / len(got)

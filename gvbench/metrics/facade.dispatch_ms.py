"""Host milliseconds a ``GrapevineEngine.handle_queries_async`` call takes
(validate, pack, admission, upload and enqueue of one round), the mean over
every call of the window, timed by the benchmark around the call."""


def read(run: dict):
    calls = run["dispatch_s"]
    return 1e3 * sum(calls) / len(calls) if calls else None

"""Host milliseconds a window round spends in the facade's ``pack`` span
(validate and pack the batch, before the engine's lock), the program's own
span ledger (``PendingRound.spans``), the mean over the window's rounds."""


def read(run: dict):
    got = [r["host"]["pack"][1] for r in run["spans"] if "pack" in r["host"]]
    if not got or len(got) != len(run["spans"]):
        return None
    return 1e3 * sum(got) / len(got)

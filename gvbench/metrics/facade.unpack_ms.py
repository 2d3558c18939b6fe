"""Host milliseconds a window round spends in the facade's ``demux`` span
(unpack the round's answers at ``PendingRound.resolve``), the program's own
span ledger, the mean over the window's rounds."""


def read(run: dict):
    got = [r["host"]["demux"][1] for r in run["spans"] if "demux" in r["host"]]
    if not got or len(got) != len(run["spans"]):
        return None
    return 1e3 * sum(got) / len(got)

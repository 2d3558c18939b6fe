"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee of the
configuration broken, judged exactly as a run's answers are. Its reading
must come out far above the limit (0 wrong answers).

    python3 -m gvbench.control --workload <name> --rounds <n> --seeds <s> [<s> ...]

runs ``--rounds`` rounds of the cell's traffic (the warm-up included, as
many as a run completes) and the read-back rounds, for each broken
guarantee and seed, and prints one JSON line each. The program is not run.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from . import judge, reference, traffic
from .run import ROOT, find, load_bench


class NoCap(reference.Bus):
    """Accepts a CREATE into a full mailbox: the 62-message cap broken."""

    def __init__(self, *a):
        super().__init__(*a)
        self.mailbox_cap = 1 << 30


class Newest(reference.Bus):
    """A zero-id READ or DELETE takes the newest message of the mailbox, not
    the oldest: the mailbox's FIFO order broken."""

    @staticmethod
    def head(box):
        return box[-1]

    @staticmethod
    def pop(box):
        return box.pop()


class PopNotKept(reference.Bus):
    """A zero-id DELETE answers its message but leaves it in the mailbox:
    a delete the bus does not keep. (A mailbox that never holds two
    messages, as a lone client's, cannot tell the two above.)"""

    @staticmethod
    def pop(box):
        return box[0]


BROKEN = {"no_cap": NoCap, "newest_first": Newest, "pop_not_kept": PopNotKept}


def control_reading(cell: dict, bench: dict, seed: int, rounds: int, broken: str,
                    engine_overrides: dict | None = None) -> dict:
    """Wrong answers the judge finds when ``broken`` answers ``rounds``
    rounds of the cell's traffic and then its read-back."""
    config = find(bench["configs"], cell["config"], "configuration")
    cfile = json.loads((ROOT / config["file"]).read_text())
    knobs = dict(cfile["engine"], **(engine_overrides or {}))
    payload_size = int(cfile["record_size"]) - 88
    mix = traffic.Traffic(traffic.load(cell["traffic"]), batch_size=knobs["batch_size"],
                          max_recipients=knobs["max_recipients"],
                          payload_size=payload_size, seed=seed)
    args = (knobs["max_messages"], knobs["max_recipients"], knobs["mailbox_cap"], payload_size)
    program = BROKEN[broken](*args)
    ids = random.Random(seed)
    j = judge.Judge(reference.Bus(*args))
    acked, wrong = [], {"rounds": 0, "readback": 0}
    for k in range(rounds + 1):
        ops = mix.ops(k) if k < rounds else None
        batches = [("rounds", ops)] if ops is not None else [
            ("readback", rb) for rb in mix.readback(acked)]
        for label, ops in batches:
            issued = [ids.getrandbits(128).to_bytes(16, "little") for _ in ops]
            got = judge.Answers.of_rows(program.round(ops, mix.now(k), issued))
            wrong[label] += j.round(label, ops, mix.now(k), got)
            if label == "rounds" and k >= mix.warmup:
                acked += [(got.msg_id_at(i), op[1], op[3]) for i, op in enumerate(ops)
                          if op[0] == reference.CREATE and got.status_at(i) == reference.SUCCESS]
    return {"workload": cell["name"], "seed": seed, "broken": broken, "rounds": rounds,
            "wrong_answers": wrong["rounds"], "wrong_readbacks": wrong["readback"],
            "judged": j.judged}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gvbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rounds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = load_bench(ROOT)
    cell = find(bench["workloads"], args.workload, "workload")
    for broken in BROKEN:
        for seed in args.seeds:
            print(json.dumps(control_reading(cell, bench, seed, args.rounds, broken)))
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

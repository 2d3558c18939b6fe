"""The one traffic generator. A mix is a data file, ``gvbench/traffic/<name>.json``;
this module turns its parameters, the configuration's sizes and a seed into
rounds of operations. The same seed gives the same rounds.

An operation is ``(kind, auth, msg_id, recipient, payload)`` in plain
bytes, what a client puts into a request; the harness wraps it for the
program and the reference reads it as it is. Keys:

- ``loop``: ``"closed"``, with ``in_flight`` rounds outstanding;
- ``ops_per_round``: ``"batch_size"`` (one full batch) or a number;
- ``mix``: a list of ``{"kind", "share", "auth", "recipient", "payload"}``.
  Each round holds every kind at its share of the round, rounded, in an
  order drawn from the seed, so every seed does the same amount of each
  kind of work. ``auth`` and ``recipient`` are ``"uniform"`` or ``"zipf"``
  over the identity pool, or ``"zero"``; ``payload`` is ``"random"`` or
  ``"zero"``. Every message id sent is zero: a READ or DELETE takes the
  oldest message addressed to its auth identity;
- ``sequence`` (optional, in place of the shares): a list of kinds; every
  op of round ``r`` is of kind ``sequence[r % len(sequence)]``, drawn as
  that kind's ``mix`` entry says. ``distinct_rounds`` and
  ``warmup_rounds`` are then multiples of its length, so the cycle and
  the window both start at its head;
- ``zipf_theta`` (where a ``mix`` entry draws ``"zipf"``): the zipfian
  constant; rank ``r`` (from 1) is drawn with weight ``r ** -theta``, and
  the ranks are dealt to identities in an order drawn from the seed;
- ``identity_pool_share_of_max_recipients``: the identity pool's size as a
  share of the configuration's ``max_recipients``;
- ``distinct_rounds``: rounds made before the run; the run cycles through
  them, with a clock that keeps moving (``clock_start``,
  ``clock_step_per_round``);
- ``warmup_rounds``: the first rounds, run in set-up;
- ``readback_rounds``, ``readback_by_recipient_share``: the rounds of
  reads by id sent after the window, over a sample of the messages the
  window's creates acknowledged, by their recipient or else their sender.
"""

from __future__ import annotations

import bisect
import itertools
import json
import random
from pathlib import Path

HERE = Path(__file__).resolve().parent
KINDS = {"CREATE": 1, "READ": 2, "UPDATE": 3, "DELETE": 4}
ZERO_ID = bytes(16)
ZERO_KEY = bytes(32)


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _rng(seed: int, tag: int) -> random.Random:
    return random.Random(((seed % (1 << 64)) << 8) | tag)


class Traffic:
    """The rounds of one mix at one configuration and seed."""

    def __init__(self, params: dict, *, batch_size: int, max_recipients: int,
                 payload_size: int, seed: int):
        if params["loop"] != "closed":
            raise ValueError(f"unknown loop {params['loop']!r}")
        self.params = params
        self.in_flight = int(params["in_flight"])
        per = params["ops_per_round"]
        self.n = batch_size if per == "batch_size" else int(per)
        if not 1 <= self.n <= batch_size:
            raise ValueError(f"{self.n} ops a round do not fit a batch of {batch_size}")
        self.seed = seed
        self.payload_size = payload_size
        self.zero_payload = bytes(payload_size)
        rng = _rng(seed, 1)
        pool = max(1, int(max_recipients * params["identity_pool_share_of_max_recipients"]))
        raw = rng.randbytes(32 * pool)
        self.identities = [raw[i * 32:(i + 1) * 32] for i in range(pool)]
        if ZERO_KEY in self.identities:
            raise ValueError("the seed drew the zero identity")
        self._cdf = None
        if "zipf_theta" in params:
            theta = float(params["zipf_theta"])
            self._cdf = list(itertools.accumulate(r ** -theta for r in range(1, pool + 1)))
        self._rank_owner = list(range(pool))
        rng.shuffle(self._rank_owner)
        self._noise = rng.randbytes(1 << 16)
        n_rounds, self.warmup = int(params["distinct_rounds"]), int(params["warmup_rounds"])
        self._sequence = None
        if "sequence" in params:
            names = [m["kind"] for m in params["mix"]]
            self._sequence = [names.index(kd) for kd in params["sequence"]]
            if n_rounds % len(self._sequence) or self.warmup % len(self._sequence):
                raise ValueError(f"distinct_rounds ({n_rounds}) and warmup_rounds "
                                 f"({self.warmup}) must be multiples of the sequence's "
                                 f"length ({len(self._sequence)})")
        else:
            counts = [int(round(m["share"] * self.n)) for m in params["mix"]]
            counts[counts.index(max(counts))] += self.n - sum(counts)
            self._slots = [i for i, c in enumerate(counts) for _ in range(c)]
        self.rounds = [self._round(r, rng) for r in range(n_rounds)]

    def _draw(self, how: str, rng, n: int) -> list:
        if how == "zero":
            return [ZERO_KEY] * n
        ids = self.identities
        if how == "uniform":
            return [ids[rng.randrange(len(ids))] for _ in range(n)]
        if how == "zipf":
            if self._cdf is None:
                raise ValueError("a zipf draw needs zipf_theta")
            cdf, top, last = self._cdf, self._cdf[-1], len(ids) - 1
            return [ids[self._rank_owner[min(last, bisect.bisect_right(cdf, rng.random() * top))]]
                    for _ in range(n)]
        raise ValueError(f"unknown key distribution {how!r}")

    def _payloads(self, how: str, r: int, slots, rng) -> list:
        if how == "zero":
            return [self.zero_payload] * len(slots)
        if how != "random":
            raise ValueError(f"unknown payload {how!r}")
        body = self.payload_size - 8
        out = []
        for j in slots:
            o = rng.randrange(len(self._noise) - body)
            out.append(((r << 32) | j).to_bytes(8, "little") + self._noise[o:o + body])
        return out

    def _round(self, r: int, rng) -> list:
        if self._sequence is not None:
            kinds = [self._sequence[r % len(self._sequence)]] * self.n
        else:
            kinds = list(self._slots)
            rng.shuffle(kinds)
        ops: list = [None] * self.n
        for i, m in enumerate(self.params["mix"]):
            slots = [j for j, kd in enumerate(kinds) if kd == i]
            auth = self._draw(m["auth"], rng, len(slots))
            rcp = self._draw(m["recipient"], rng, len(slots))
            pay = self._payloads(m["payload"], r, slots, rng)
            kind = KINDS[m["kind"]]
            for j, a, c, p in zip(slots, auth, rcp, pay):
                ops[j] = (kind, a, ZERO_ID, c, p)
        return ops

    def ops(self, k: int) -> list:
        """The operations of round ``k`` (counted from the first warm-up round)."""
        return self.rounds[k % len(self.rounds)]

    def now(self, k: int) -> int:
        return int(self.params["clock_start"]) + k * int(self.params["clock_step_per_round"])

    def readback(self, acked: list) -> list:
        """Rounds of reads by id over a sample of ``acked``, a list of
        ``(msg_id, sender, recipient)`` the window's creates were answered
        with; the sample is drawn from the seed."""
        n_rounds = int(self.params["readback_rounds"])
        if not acked or not n_rounds:
            return []
        rng = _rng(self.seed, 2)
        share = float(self.params["readback_by_recipient_share"])
        ops = []
        for _ in range(n_rounds * self.n):
            mid, snd, rcp = acked[rng.randrange(len(acked))]
            by_rcp = rng.random() < share
            ops.append((KINDS["READ"], rcp if by_rcp else snd, mid, ZERO_KEY, self.zero_payload))
        return [ops[k * self.n:(k + 1) * self.n] for k in range(n_rounds)]

"""Round-phase names, wall-clock phase timers, and device trace ranges
(port of ``grapevine_tpu/obs/phases.py``).

Phase timing is safe only at batch granularity: every phase covers the
whole fixed-size round, so its duration is a function of (capacity,
batch size), never of which ops or whose ops are inside.

Host-side phases (histograms + ``torch.profiler`` ranges), as in the
reference:

- ``assembly``  — scheduler collection window
                  (``server/scheduler.py``, the collector's window close)
- ``verify``    — batched sr25519 signature verification
                  (``server/scheduler.py``, one batch verify a round)
- ``dispatch``  — journal barrier + round enqueue (``engine/batcher.py``)
- ``evict``     — the wait for the round's device work, measured from the
                  host at resolve (per-stage device splits are in a
                  profiler trace, under the ``record_function`` spans)
- ``demux``     — device→wire response unpacking
- ``sweep``     — expiry sweep (``engine/expiry.py``)
- ``journal``   — sealed batch-journal append + fsync (``engine/journal.py``)
- ``checkpoint``— sealed whole-state checkpoint write
- ``replay``    — startup recovery (checkpoint load + journal replay)
- ``sort``      — the round's sort workload, measured by calibration
                  (``engine/batcher.py:GrapevineEngine.calibrate_sort_phase``):
                  every sort the round runs is shape-static and
                  data-independent, so the same sorts at the round's
                  shapes, run standalone, are the per-round sort cost
- ``posmap``    — the round's position resolution, calibrated the same
                  way (``GrapevineEngine.calibrate_posmap_phase``: the
                  three ORAM rounds' lookups and remaps, the internal
                  ORAM rounds under a recursive map)
- ``flush``     — delayed-eviction flush enqueue

Device-side ranges (:func:`device_phase`): ``record_function`` ranges
under the reference's ``device_phase`` names, so a ``torch.profiler``
trace attributes device time per ORAM stage.
"""

from __future__ import annotations

import contextlib
import time

from torch.profiler import record_function

#: canonical phase label values — the registry declares exactly these,
#: so a typo'd phase name raises instead of minting a new series
PHASES = ("assembly", "verify", "dispatch", "evict", "demux", "sweep",
          "journal", "checkpoint", "replay", "sort", "posmap", "flush")

#: fixed histogram boundaries for phase durations (seconds)
PHASE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: fixed boundaries for stash occupancy samples (entries)
STASH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 48.0, 64.0, 96.0, 128.0)


@contextlib.contextmanager
def phase_timer(histogram, phase: str, annotate: bool = True):
    """Time a host-side phase into ``histogram{phase=...}``.

    Also opens a ``torch.profiler.record_function`` range
    ``grapevine/<phase>`` so host phases line up with the device kernels
    in a profiler trace (a no-op costing well under a microsecond when no
    profiler is active; the name is the static phase, never request
    data)."""
    ann = record_function(f"grapevine/{phase}") if annotate else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with ann:
            yield
    finally:
        if histogram is not None:
            histogram.observe(time.perf_counter() - t0, phase=phase)


def device_phase(name: str):
    """A ``record_function`` range for a phase inside the round (the
    reference's ``jax.named_scope`` wrapper)."""
    return record_function(name)

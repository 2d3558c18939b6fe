"""Programmatic ``torch.profiler`` capture for a live engine (port of
``grapevine_tpu/obs/profiler.py``).

The profiler is the only instrument that can split device time inside
the round (the host phase timers stop at the ``evict`` wait; the
``record_function`` ranges of obs/phases.py only become visible in a
profiler capture). ``/profile?ms=N`` (obs/httpd.py) starts a
``torch.profiler`` session on the live process with the CPU activity
(and the CUDA one when the engine runs on the card), records every
thread — the scheduler's collector thread dispatches the rounds, the
HTTP thread only asks — sleeps N milliseconds while the engine keeps
serving, stops, and writes a Chrome trace into ``capture-NNNN/`` under
the gate's directory. Load it in Perfetto next to ``/trace``'s round
spans.

Gated and bounded by design: the endpoint exists only when the operator
passed ``--profile-enable`` (a capture costs real overhead and writes
device-level traces to disk), one capture runs at a time (a second
request gets 409 rather than corrupting the active session), and the
duration is clamped to ``max_ms``. torch does not refuse a second live
profiler: starting one silently ends the other's session. So every
capture in the process goes through :func:`exclusive_profile`, which
holds one process-wide lock and raises :class:`ProfilerBusy` while
another capture is live (the gate's or any other caller's).

Leak stance: the profiler records *phase-level* ranges
(``grapevine/<phase>`` and the round's stage names — obs/phases.py) and
kernel timings, all functions of (capacity, batch size); request
payloads and identities never enter trace metadata. The capture
directory itself stays operator-local — the endpoint returns its path,
never its contents.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

#: held by the live capture of this process (torch keeps one session)
_LIVE = threading.Lock()


class ProfilerBusy(RuntimeError):
    """A capture is already in progress (one at a time by design)."""


@contextlib.contextmanager
def exclusive_profile(device_type: str = "cpu", all_threads: bool = True, **kw):
    """``torch.profiler.profile`` with the CPU activity (and CUDA when
    ``device_type`` is ``"cuda"``), every thread recorded when
    ``all_threads``; raises :class:`ProfilerBusy` instead of starting
    while another capture of this process is live, or when torch
    refuses to start one."""
    from torch.profiler import ProfilerActivity, profile

    if not _LIVE.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture is already in progress; retry "
                           "when it completes")
    try:
        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        if all_threads:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        prof = profile(activities=acts, **kw)
        try:
            prof.__enter__()
        except RuntimeError as exc:
            raise ProfilerBusy(f"torch refused a profiler session: {exc}") from exc
        try:
            yield prof
        finally:
            prof.__exit__(None, None, None)
    finally:
        _LIVE.release()


class ProfilerGate:
    """Serialized, duration-clamped ``torch.profiler`` capture trigger."""

    def __init__(self, outdir: str | None = None, max_ms: int = 60_000,
                 device_type: str = "cpu"):
        import tempfile

        self.outdir = outdir or os.path.join(
            tempfile.gettempdir(), f"grapevine-profile-{os.getpid()}"
        )
        self.max_ms = max_ms
        self.device_type = device_type
        self._lock = threading.Lock()
        self._n = 0
        #: set while a capture's session is recording (after the profiler
        #: has started, before it stops): work meant to land in the trace
        #: waits for it
        self.live = threading.Event()

    def capture(self, ms: int = 1000) -> dict:
        """Run one profiler capture of ``ms`` milliseconds (clamped to
        [1, max_ms]); returns ``{"trace_dir", "ms"}``. Raises
        :class:`ProfilerBusy` if a capture is already running."""
        ms = max(1, min(int(ms), self.max_ms))
        if not self._lock.acquire(blocking=False):
            raise ProfilerBusy(
                "a profiler capture is already in progress; retry when "
                "it completes"
            )
        try:
            self._n += 1
            trace_dir = os.path.join(self.outdir, f"capture-{self._n:04d}")
            os.makedirs(trace_dir, exist_ok=True)
            with exclusive_profile(self.device_type) as prof:
                self.live.set()
                try:
                    time.sleep(ms / 1e3)
                finally:
                    self.live.clear()
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            return {"trace_dir": trace_dir, "ms": ms}
        finally:
            self._lock.release()

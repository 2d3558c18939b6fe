"""The fast-branch engine round replayed from one CUDA graph.

Run op by op, one round makes the host enqueue some 3,500 kernels, and on
the card that enqueue, not the kernels, sets the round's period. A
:class:`RoundGraph` captures ``engine_round_step(..., fast_ok=True)``
once and replays it with one launch. The kernels inside are the eager
round's, unchanged; ``engine_round_step`` stays the eager program and the
analyzers' capture target.

A graph replays fixed addresses, so the round it captures is static:

- the batch is read from one device buffer that every upload of the
  engine copies into (``batcher.upload_batch(..., out=)``);
- the engine's state is read and written in place: the trees already are
  (``oram/round.py``), and the round's other planes are copied back into
  the state's tensors at the end of the captured region
  (:func:`copy_state_`), so the state keeps its addresses from round to
  round; a state set from outside is copied into them the same way;
- the responses and the transcript are the graph's own output tensors.
  The facade copies them to pinned host memory right behind each replay,
  on the same stream, so stream order keeps round n's outputs from replay
  n+1 and two rounds in flight need no second graph.

The state's generators are registered with the graph, so every replay
draws fresh leaves and id words from where the generator stands, and the
same ones the eager round would draw from that generator state.

The kernel wrappers' launch counters (``LAUNCHES``) count the wrappers'
calls: the capture calls each once, and a replay calls none (its kernels
launch from the graph). The engine counts its replays itself
(``health()["round_graph"]``).
"""

from __future__ import annotations

import gc

import torch

from .round_step import engine_round_step
from .state import EngineConfig, EngineState

#: why a round runs op by op instead of replaying the graph: the first
#: fast round (``warmup``), the slow admission branch, and engines that
#: never replay: off the card, on a mesh, or op-major
EAGER_REASONS = ("warmup", "slow_branch", "not_cuda", "mesh", "op_major")


def _leaves(state, prefix: str = ""):
    """``(name, leaf)`` over a state's tensors and generators, nested
    named tuples (the trees, a recursive position map) flattened."""
    for name, value in zip(state._fields, state):
        if hasattr(value, "_fields"):
            yield from _leaves(value, f"{prefix}{name}.")
        elif value is not None:
            yield prefix + name, value


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def copy_state_(static: EngineState, new: EngineState) -> None:
    """Copy ``new`` into ``static`` leaf by leaf, so that ``static``'s
    tensors and generators keep their addresses: a leaf that already is
    ``static``'s (the trees, written in place) is skipped, a generator
    takes the other's state. A leaf that lies in the memory of any of
    ``static``'s tensors otherwise is cloned before anything is copied,
    so the order of the copies cannot matter. Raises on a leaf of another
    shape or type (another geometry)."""
    old = dict(_leaves(static))
    storages = {t.untyped_storage().data_ptr() for t in old.values()
                if isinstance(t, torch.Tensor)}
    pairs = []
    for name, src in _leaves(new):
        dst = old.get(name)
        if type(dst) is not type(src) or (
                isinstance(src, torch.Tensor)
                and (dst.shape != src.shape or dst.dtype != src.dtype)):
            raise ValueError(f"state leaf {name} does not fit this engine's state")
        if src is dst:
            continue
        if isinstance(src, torch.Generator):
            dst.set_state(src.get_state())
        elif src.numel() and not _same_memory(src, dst):
            if src.untyped_storage().data_ptr() in storages:
                src = src.clone()
            pairs.append((dst, src))
    for dst, src in pairs:
        dst.copy_(src)


def static_round(ecfg: EngineConfig, state: EngineState, batch: dict
                 ) -> tuple[dict, torch.Tensor]:
    """The round a :class:`RoundGraph` captures: one fast-branch round of
    ``engine_round_step`` over ``state``, its output state copied back
    into ``state`` (:func:`copy_state_`); returns ``(responses,
    transcript)``."""
    new, resp, transcript = engine_round_step(ecfg, state, batch, fast_ok=True)
    copy_state_(state, new)
    return resp, transcript


class RoundGraph:
    """One fast-branch round of ``ecfg``'s engine, captured on the card
    over ``state`` (whose tensors and generators it reads and writes in
    place from then on) and ``batch`` (views of the engine's upload
    buffer). Capture records and runs nothing: every round, the capturing
    one included, runs by :meth:`replay`.

    The capture runs on a stream of its own, in ``thread_local`` mode, so
    another thread's CUDA calls (a resolve waiting on its round's event)
    cannot invalidate it, and with the collector off, so that no object
    freed in a collection touches the default stream meanwhile; the round
    makes no host sync, or the capture raises. Nothing the capture
    allocates outlives the graph, so a freed engine returns the graph's
    private pool whole."""

    def __init__(self, ecfg: EngineConfig, state: EngineState, batch: dict):
        self._graph = torch.cuda.CUDAGraph()
        for gen in (state.rng, state.pm_rng):
            if gen is not None:
                self._graph.register_generator_state(gen)
        self._stream = torch.cuda.Stream(device=batch["req_type"].device)
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            # cuBLAS's workspace for this stream (the round's float64
            # matmuls), which PyTorch keeps for the process's life: made
            # here it comes from the ordinary pool; made inside the capture
            # it would pin the graph's private pool after the graph is gone
            torch.cuda.current_blas_handle()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                self._graph.capture_begin(capture_error_mode="thread_local")
                try:
                    #: the graph's outputs, rewritten by every replay
                    self._resp, self._transcript = static_round(ecfg, state, batch)
                finally:
                    self._graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(self._stream)

    def replay(self) -> tuple[dict, torch.Tensor]:
        """Enqueue one round on the current stream; returns the graph's
        ``(responses, transcript)``, valid in stream order until the next
        replay."""
        self._graph.replay()
        return self._resp, self._transcript

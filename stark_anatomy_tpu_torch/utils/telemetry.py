"""Spans of the proving pipeline, on the host's clock and on the device's.

Usage:
    from stark_anatomy_tpu_torch.utils import telemetry
    with telemetry.device_phase("prove.trace-lde", device):  # a CUDA device starts the device clock
        with telemetry.phase("lde-ntt"):                      # a nested span inherits it
            ...
    telemetry.report()
    # -> {"prove.trace-lde": {"seconds": ..., "calls": ...},
    #     "prove.trace-lde.lde-ntt": {...},
    #     "prove.trace-lde@device": {"seconds": ..., "calls": ...}, ...}

Host clock: each span's seconds on time.perf_counter under its dotted name
(the stack of open spans). Kernel launches are asynchronous, so a span's
host seconds are the time to enqueue its work unless it waits for the
device. The top-level phases of iop/stark.py (``_phase``) end with an
unconditional ``torch.cuda.synchronize``, so theirs cover their device work.

Device clock: a ``device_phase`` on a CUDA device, and every span inside it,
records a timing event when it opens and when it closes, on the stream that
was the device's current one when the device_phase opened. ``<name>@device`` sums the elapsed times between the two:
the span's extent on the device stream, including the device's idle time
inside it. The pairs are read lazily, never with a synchronise: after each
``device_wait`` (the device has then run everything queued before it), when
more than _MAX_PENDING pairs are unread (those already done), and in
``report()``, which waits on the last unread event alone. Read events are
reused, so the live events stay bounded. A span on the CPU makes no CUDA
call and has no ``@device`` entry.

Host waits: ``device_wait(device)`` is the span ``device-wait`` around a
point where the host blocks on a CUDA device: a synchronise, a copy to the
host, or a copy from pageable host memory to the device (torch synchronises
the stream after such a copy). Its seconds are the time the host was
blocked, its calls the number of drains. It does not nest, and on a CPU
device it opens nothing.

Counts: ``count(name)`` adds one call to the entry ``name`` under the
innermost open span, as a span's dotted name, and nothing else: its seconds
stay 0, it records no device event and opens no profiler range. It says how
often something happened inside a span, such as which route a copy took.

Profiler ranges: while a torch profiler is active, every span also opens a
``record_function`` range under the name it was opened with, so a device
trace names what the host was doing; with none active it opens none.

STARK_ANATOMY_LOG (read once, at import): when set, one JSON line per
closed span on stderr, host clock only (the device clock resolves later).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.autograd.profiler import record_function

#: the name of the span around a point where the host blocks on the device
DEVICE_WAIT = "device-wait"
#: suffix of the device-clock entry of a span in report()
DEVICE_SUFFIX = "@device"
#: unread event pairs beyond which a closing span reads those already done
_MAX_PENDING = 256

_LOG = bool(os.environ.get("STARK_ANATOMY_LOG"))


class _State(threading.local):
    full = ""  # dotted name of the innermost open span
    name = ""  # its own name
    clock = None  # (stream, idle events) of the device clock it keeps, or None


_state = _State()
_totals: Dict[str, Dict[str, float]] = defaultdict(lambda: {"seconds": 0.0, "calls": 0})
_lock = threading.Lock()
_pending: List[tuple] = []  # (name@device, event pool, start, end) of closed spans, unread, in close order
_idle_events: Dict[int, list] = {}  # read timing events, for reuse, per device index
_INHERIT = object()  # a span's clock: the enclosing span's


def _cuda(device) -> torch.device | None:
    """`device` as a torch.device when it is a CUDA device, else None."""
    if device is None:
        return None
    dev = device if isinstance(device, torch.device) else torch.device(device)
    return dev if dev.type == "cuda" else None


def _record(clock):
    """A timing event recorded now on the clock's stream."""
    stream, pool = clock
    event = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def _read(pairs) -> None:
    """Add the elapsed times of completed pairs to their entries (lock held)."""
    elapsed = [start.elapsed_time(end) for _, _, start, end in pairs]
    for (name, pool, start, end), ms in zip(pairs, elapsed):
        entry = _totals[name]
        entry["seconds"] += ms * 1e-3
        entry["calls"] += 1
        pool += (start, end)


def _read_done() -> None:
    """Read the unread pairs whose end event has completed, oldest first,
    up to the first that has not."""
    with _lock:
        k = 0
        while k < len(_pending) and _pending[k][3].query():
            k += 1
        if k:
            _read(_pending[:k])
            del _pending[:k]


def _read_drained() -> None:
    """After a device-wait: the stream of a prove's spans has run everything
    queued before it, so every unread pair has completed and is read with
    no query. Should one not have (a span on another stream), elapsed_time
    refuses and those done are read."""
    with _lock:
        try:
            _read(_pending)
        except RuntimeError:
            pass
        else:
            _pending.clear()
            return
    _read_done()


class _Span:
    __slots__ = ("name", "clock", "outer", "full", "t0", "start", "range")

    def __init__(self, name: str, clock):
        # clock: (stream, event pool), None for no device clock, or _INHERIT
        self.name, self.clock = name, clock

    def __enter__(self) -> None:
        st = _state
        self.outer = (st.full, st.name, st.clock)
        self.full = st.full + "." + self.name if st.full else self.name
        st.full, st.name = self.full, self.name
        if self.clock is _INHERIT:
            self.clock = st.clock
        else:
            st.clock = self.clock
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        self.start = None if self.clock is None else _record(self.clock)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        _state.full, _state.name, _state.clock = self.outer
        with _lock:
            entry = _totals[self.full]
            entry["seconds"] += dt
            entry["calls"] += 1
            if self.start is not None:
                _pending.append((self.full + DEVICE_SUFFIX, self.clock[1], self.start, _record(self.clock)))
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if len(_pending) > _MAX_PENDING:
            _read_done()
        if _LOG:
            print(json.dumps({"phase": self.full, "seconds": round(dt, 6)}), file=sys.stderr, flush=True)


_NO_SPAN = contextlib.nullcontext()


def phase(name: str) -> _Span:
    """A span of the pipeline; nests (dotted names show the stack). It has
    the device clock of the span it opens in, if that has one."""
    return _Span(name, _INHERIT)


def device_phase(name: str, device) -> _Span:
    """A span that also clocks `device`, and so do the spans inside it, when
    it is a CUDA device: on the stream current when it opens. On another
    device neither has a device clock."""
    dev = _cuda(device)
    if dev is None:
        return _Span(name, None)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _Span(name, (torch.cuda.current_stream(index), _idle_events.setdefault(index, [])))


class _Wait:
    """The span device-wait: the host clock alone (its extent on the device
    says nothing), and the unread device clocks read when it closes."""

    __slots__ = ("outer", "full", "t0", "range")

    def __enter__(self) -> None:
        st = _state
        self.outer = (st.full, st.name)
        self.full = st.full + "." + DEVICE_WAIT if st.full else DEVICE_WAIT
        st.full, st.name = self.full, DEVICE_WAIT
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = record_function(DEVICE_WAIT)
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        _state.full, _state.name = self.outer
        with _lock:
            entry = _totals[self.full]
            entry["seconds"] += dt
            entry["calls"] += 1
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if _pending:
            _read_drained()
        if _LOG:
            print(json.dumps({"phase": self.full, "seconds": round(dt, 6)}), file=sys.stderr, flush=True)


def device_wait(device):
    """The span ``device-wait`` around a point where the host blocks on
    `device`; nothing on a CPU device or inside another device-wait."""
    if _state.name == DEVICE_WAIT or _cuda(device) is None:
        return _NO_SPAN
    return _Wait()


def count(name: str) -> None:
    """One call of the calls-only entry `name` under the innermost open span."""
    full = _state.full + "." + name if _state.full else name
    with _lock:
        _totals[full]["calls"] += 1


def report() -> Dict[str, Dict[str, float]]:
    """Accumulated per-span totals since the last reset: host-clock entries
    under each span's dotted name, device-clock ones under name@device.
    Waits on the last unread device event, and on nothing else."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    if pending:
        pending[-1][3].synchronize()
    with _lock:
        _read(pending)
        return {k: dict(v) for k, v in _totals.items()}


def reset() -> None:
    with _lock:
        for _, pool, start, end in _pending:
            pool += (start, end)
        _pending.clear()
        _totals.clear()

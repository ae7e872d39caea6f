"""Write-behind worker for the per-e-fold file products.

The reference rewrites its full product suite (resume, posterior,
equal-weights, live, dead, stats) every compression e-fold from the
administrator (``src/polychord/nested_sampling.F90:329-334``) — for the
Fortran administrator that cost is negligible against a slow likelihood,
but for an administrator fed by a batched device engine the text
formatting is one of the largest host phases (metrics.jsonl
``host_breakdown``).

This worker moves the formatting+IO off the critical path: the
administrator snapshots the run state (a deepcopy — array copies, ~ms)
and hands a write closure to a single background thread.  The queue
holds ONE pending intermediate write: a newer snapshot replaces an
unwritten older one (each write is a full replacement of the same
files, so dropping a stale intermediate write loses nothing).  The final
write at run end is synchronous after ``flush()``, so run completion
still guarantees files match the final state.  Worker exceptions are
re-raised on the administrator thread at the next submit/flush.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class WriteBehindWriter:
    def __init__(self):
        self._lock = threading.Condition()
        self._pending: Optional[Callable[[], None]] = None
        self._error: Optional[BaseException] = None
        self._stop = False
        self._busy = False
        self._thread = threading.Thread(
            target=self._loop, name="polychord-write-behind", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._lock.wait()
                if self._stop and self._pending is None:
                    return
                fn, self._pending = self._pending, None
                self._busy = True
            try:
                fn()
            except BaseException as e:  # surfaced at next submit/flush
                with self._lock:
                    self._error = e
            finally:
                with self._lock:
                    self._busy = False
                    self._lock.notify_all()

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, fn: Callable[[], None]) -> None:
        """Queue a write closure; replaces any not-yet-started one."""
        with self._lock:
            self._raise_pending_error()
            self._pending = fn
            self._lock.notify_all()

    def flush(self) -> None:
        """Block until the worker is idle with nothing pending."""
        with self._lock:
            while self._pending is not None or self._busy:
                self._lock.wait()
            self._raise_pending_error()

    def close(self) -> None:
        self.flush()
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=30)

"""FIFO-fair reentrant device lock.

``threading.RLock`` has no fairness guarantee: under the GIL, a thread that
releases the lock and at once re-acquires it (a busy batching worker
looping over a full queue) wins almost every handoff and starves the other
waiters, so a stream's ticks could wait behind batch after batch.

``FairRLock`` keeps a queue of per-waiter events; ``release`` hands
ownership straight to the longest-waiting thread instead of racing.
Reentrant like RLock (the service's cold-voice path nests acquisitions).
Copied from the JAX package's ``serve/fairlock.py``.
"""

import threading
from collections import deque


class FairRLock:
    def __init__(self):
        self._mu = threading.Lock()
        self._owner = None
        self._count = 0
        self._waiters = deque()  # (thread_ident, Event) in arrival order

    def acquire(self, blocking: bool = True, timeout: float = -1):
        me = threading.get_ident()
        with self._mu:
            if self._owner == me:
                self._count += 1
                return True
            if self._owner is None and not self._waiters:
                self._owner = me
                self._count = 1
                return True
            if not blocking:
                return False
            ev = threading.Event()
            entry = (me, ev)
            self._waiters.append(entry)
        ok = ev.wait(timeout if timeout and timeout > 0 else None)
        if not ok:  # timed out: withdraw the ticket (unless just handed off)
            with self._mu:
                if ev.is_set():
                    return True  # handoff raced the timeout; we own it
                try:
                    self._waiters.remove(entry)
                except ValueError:
                    pass
            return False
        return True

    def release(self):
        with self._mu:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release un-acquired FairRLock")
            self._count -= 1
            if self._count > 0:
                return
            if self._waiters:
                tid, ev = self._waiters.popleft()
                self._owner = tid  # direct FIFO handoff, no re-race
                self._count = 1
                ev.set()
            else:
                self._owner = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

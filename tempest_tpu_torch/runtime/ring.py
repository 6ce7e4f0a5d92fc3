"""Host-side real-time plumbing: ring buffer, rate meters.

Re-designs the reference's ``AtomicAbstractSDRs`` concurrency layer
(``/root/reference/src/AtomicAbstractSDRs.jl:28-341``) for the TPU runtime's
host side.  Semantics preserved:

* bounded ring of fixed-size IQ blocks, *overwrite-oldest* on overflow — the
  radio is never blocked; overflows are counted, not prevented
  (``AtomicAbstractSDRs.jl:161-190``);
* consumer blocks until data is available (``wait_consData`` ``:147-155``);
* producer/consumer throughput meters in Msamples/s plus an overflow counter
  (``Rate`` ``:199-268``, ``print_summary`` ``:333-341``).

Implementation differences (host-native, not a port): one preallocated numpy
arena with a condition variable instead of per-slot ``ReentrantLock`` spin
loops — the consumer wait is a real OS wait, not a ``yield`` spin; writes go
through ``np.copyto`` into pinned slots so the hot path is two memcpys
(driver→slot, slot→device transfer buffer).  An optional C++ arena (see
``tempest_tpu/native``) provides the same interface for zero-GIL copies.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..utils.profiling import annotate

__all__ = ["RateMeter", "RingBuffer"]


class RateMeter:
    """Throughput meter: blocks and samples per second over a window
    (reference ``Rate``/``getProducerRate``, ``AtomicAbstractSDRs.jl:199-262``)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._blocks = 0
        self._samples = 0
        self._lock = threading.Lock()

    def tick(self, n_samples: int) -> None:
        with self._lock:
            self._blocks += 1
            self._samples += n_samples

    @property
    def blocks(self) -> int:
        return self._blocks

    def rates(self) -> tuple[float, float]:
        """(blocks/s, Msamples/s) since start."""
        dt = max(time.perf_counter() - self._t0, 1e-9)
        with self._lock:
            return self._blocks / dt, self._samples / dt / 1e6

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.perf_counter()
            self._blocks = 0
            self._samples = 0


class RingBuffer:
    """Thread-safe ring of fixed-size complex64 blocks, overwrite-oldest.

    ``put(block)`` never blocks (drops the oldest unread block instead,
    counting an overflow); ``take(out)`` blocks until a block is available or
    the ring is closed.  One producer + one consumer, like the reference.
    """

    def __init__(self, block_size: int, depth: int = 16) -> None:
        if depth < 2:
            raise ValueError("ring depth must be >= 2")
        self.block_size = int(block_size)
        self.depth = int(depth)
        self._arena = np.zeros((depth, block_size), np.complex64)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._write = 0          # next slot to write
        self._count = 0          # unread blocks
        self._overflows = 0
        self._produced = 0       # total puts (monotone block sequence)
        self.last_seq = -1       # sequence number of the last block taken
        self._closed = False
        self.producer = RateMeter()
        self.consumer = RateMeter()

    # ------------------------------------------------------------- producer
    def put(self, block: np.ndarray) -> None:
        """Copy one block in; overwrite the oldest unread block when full
        (reference ``circ_put!``, ``AtomicAbstractSDRs.jl:161-172``).  Its
        span ``ring.put`` holds ``ring.put.wait`` (the lock) and
        ``ring.put.copy``."""
        if block.shape[0] != self.block_size:
            raise ValueError(
                f"block has {block.shape[0]} samples, ring expects {self.block_size}"
            )
        with annotate("ring.put"):
            with annotate("ring.put.wait"):
                self._lock.acquire()
            try:
                with annotate("ring.put.copy"):
                    np.copyto(self._arena[self._write], block, casting="same_kind")
                self._write = (self._write + 1) % self.depth
                if self._count == self.depth:
                    self._overflows += 1  # oldest block silently overwritten
                else:
                    self._count += 1
                self._produced += 1
                self._nonempty.notify()
            finally:
                self._lock.release()
        self.producer.tick(self.block_size)

    # ------------------------------------------------------------- consumer
    def take(self, out: np.ndarray | None = None, timeout: float | None = None):
        """Copy the oldest unread block out; blocks until available.
        Returns the array, or None if the ring was closed while waiting
        (reference ``circ_take!``, ``AtomicAbstractSDRs.jl:178-190``).  Its
        span ``ring.take``, under the block's sequence, holds
        ``ring.take.wait`` (the lock and the wait for a block) and
        ``ring.take.copy``."""
        with annotate("ring.take") as span:
            with annotate("ring.take.wait"):
                ok = self._wait_ready(timeout)
            try:
                if not ok or (self._count == 0 and self._closed):
                    return None
                read = (self._write - self._count) % self.depth
                if out is None:
                    out = np.empty(self.block_size, np.complex64)
                with annotate("ring.take.copy"):
                    np.copyto(out, self._arena[read])
                # Unread blocks are always the most recent `count` puts
                # (overwrite drops the oldest), so the delivered block's
                # production sequence is produced - count.  Consumers use this
                # to keep their absolute stream position (and hence the carry
                # phase) honest across overflow drops — blind `pos +=
                # block_size` accounting shears the frame grid by block_size %
                # spf per dropped block.
                self.last_seq = span.request = self._produced - self._count
                self._count -= 1
            finally:
                self._lock.release()
        self.consumer.tick(self.block_size)
        return out

    def _wait_ready(self, timeout: float | None) -> bool:
        """Take the lock and wait until a block is there or the ring is
        closed (False when ``timeout`` ran out first); returns holding the
        lock."""
        self._lock.acquire()
        try:
            return self._nonempty.wait_for(lambda: self._count > 0 or self._closed, timeout)
        except BaseException:
            self._lock.release()
            raise

    # -------------------------------------------------------------- control
    def close(self) -> None:
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()

    @property
    def overflows(self) -> int:
        return self._overflows

    @property
    def available(self) -> int:
        return self._count

    @property
    def produced(self) -> int:
        """Total blocks put so far (monotone production sequence counter) —
        lets consumers fence against stale data after a source state change
        (e.g. a retune: blocks with seq < produced-at-retune predate it)."""
        return self._produced

    def summary(self) -> str:
        """Human-readable throughput summary (reference ``print_summary``,
        ``AtomicAbstractSDRs.jl:333-341``)."""
        _, p = self.producer.rates()
        _, c = self.consumer.rates()
        return (
            f"Ring summary: producer {p:.2f} MS/s "
            f"[{self.producer.blocks} blocks] | consumer {c:.2f} MS/s "
            f"[{self.consumer.blocks} blocks] | {self._overflows} overflows"
        )

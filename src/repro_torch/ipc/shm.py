"""Shared-memory arena: pre-mapped cross-process segments + seqlock words.

The real-IPC substrate for the paper's queue pairs (§IV-C).  A
:class:`SharedMemoryArena` is one named POSIX shared-memory segment
(`multiprocessing.shared_memory`) that both endpoints map:

- the **creator** allocates the segment, writes the arena header, and
  *first-touches* every page at setup (``buf[:] = 0``), so no page faults or
  copy-on-write remaps happen on the data path — the paper's pre-mapping;
- the **attacher** opens the same name and validates the header (magic,
  version, size), mirroring the paper's connection setup handshake.

Layout: ``[ArenaHeader | user region]``.  The header carries a small table of
64-bit control words (head/tail cursors, state flags) that the ring layer
uses; single-word reads/writes of aligned int64 through numpy are the
"atomic" primitive (CPython + the GIL + a single aligned store make these
untorn in practice on every platform we target).

Multi-word metadata that one side writes while the other polls is protected
with a :class:`SeqLock` — the classic sequence lock: the writer makes the
sequence odd, writes the payload, makes it even; a reader retries whenever it
observes an odd sequence or the sequence changed across its read (torn read).

Copied from ``src/repro/ipc/shm.py``: the port keeps its own copy and
imports nothing of the JAX package.
"""
from __future__ import annotations

import os
import struct
import time
from multiprocessing import shared_memory
import numpy as np

MAGIC = 0x524F434B          # "ROCK"
VERSION = 1
_HEADER_FMT = "<IIQQ"       # magic, version, total_bytes, user_offset
_HEADER_BYTES = struct.calcsize(_HEADER_FMT)
# control-word table: the rings' cursors/flags as contiguous int64 words.
# They share cache lines (no 64B padding) — at Python's access rates false
# sharing is noise; what matters is that each word is written by one side.
N_CONTROL_WORDS = 16
_WORD_STRIDE = 8            # int64 words, contiguous (numpy view)
_CONTROL_BYTES = N_CONTROL_WORDS * _WORD_STRIDE
HEADER_REGION = 64 + _CONTROL_BYTES      # header struct padded to 64


class SeqLock:
    """Sequence lock over one aligned int64 word in shared memory.

    Writer:  ``with lock.write(): ...mutate payload...``
    Reader:  ``lock.read(fn)`` retries ``fn()`` until an even, stable
    sequence brackets the read (no torn/in-progress observation).
    """

    def __init__(self, word: np.ndarray):
        assert word.dtype == np.int64 and word.size == 1
        self._word = word

    @property
    def sequence(self) -> int:
        """Current sequence value (odd = a write is in progress)."""
        return int(self._word[0])

    def write_begin(self) -> None:
        """Make the sequence odd: readers retry until write_end."""
        seq = int(self._word[0])
        if seq % 2:
            raise RuntimeError("seqlock already held by a writer")
        self._word[0] = seq + 1           # odd: write in progress

    def write_end(self) -> None:
        """Make the sequence even again: the payload is stable."""
        seq = int(self._word[0])
        if seq % 2 == 0:
            raise RuntimeError("seqlock write_end without write_begin")
        self._word[0] = seq + 1           # even: stable

    class _WriteCtx:
        def __init__(self, lock: "SeqLock"):
            self._lock = lock

        def __enter__(self):
            self._lock.write_begin()
            return self._lock

        def __exit__(self, *exc):
            self._lock.write_end()

    def write(self) -> "SeqLock._WriteCtx":
        """Context manager bracketing a payload write with begin/end."""
        return SeqLock._WriteCtx(self)

    def read(self, fn, max_retries: int = 1_000_000,
             spin_sleep_s: float = 1e-6):
        """Run ``fn()`` under torn-read protection and return its result."""
        for _ in range(max_retries):
            s1 = int(self._word[0])
            if s1 % 2:                    # writer mid-flight
                time.sleep(spin_sleep_s)
                continue
            out = fn()
            s2 = int(self._word[0])
            if s1 == s2:
                return out
            time.sleep(spin_sleep_s)      # torn: payload changed underneath
        raise TimeoutError("seqlock read retries exhausted")


class ShmMutex:
    """Cross-process mutex built on *exclusive* shm-segment creation.

    ``shm_open(O_CREAT|O_EXCL)`` is the one atomic test-and-set the OS gives
    us without extra dependencies: creating a named segment fails with
    ``FileExistsError`` when it already exists.  Acquire = create the segment
    (stamping owner pid + wall-clock time into it); release = unlink it.

    Used by the listener's registration handshake, where multiple client
    processes that share nothing but a name must take turns writing the
    rendezvous mailbox (our rings are strictly SPSC).

    A holder that dies without releasing would wedge everyone, so contenders
    break locks older than ``stale_s``.  ``shm_unlink`` removes *by name*,
    so a breaker re-reads the stamp from a freshly attached handle right
    before unlinking and only proceeds if it still matches the stale stamp
    it decided on — a segment some other breaker just re-created (fresh
    stamp) is left alone.  A residual race remains (two breakers can pass
    the re-check before either unlinks; POSIX shm has no compare-and-unlink)
    but it needs a holder death *plus* two simultaneous breakers, and its
    worst case is bounded: the registration mailbox writer raises (seqlock
    write_begin refuses a second writer) or a registration times out and
    can be retried — never silent corruption.
    """

    _STAMP_FMT = "<qd"          # owner pid, wall-clock acquire time

    def __init__(self, name: str, stale_s: float = 30.0):
        self.name = name
        self.stale_s = stale_s
        self._held: shared_memory.SharedMemory | None = None

    def acquire(self, timeout_s: float = 10.0,
                poll_s: float = 0.002) -> None:
        """Take the lock, breaking stale holders; TimeoutError on contention."""
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                seg = shared_memory.SharedMemory(
                    self.name, create=True,
                    size=struct.calcsize(self._STAMP_FMT))
                struct.pack_into(self._STAMP_FMT, seg.buf, 0,
                                 os.getpid(), time.time())
                self._held = seg
                return
            except FileExistsError:
                self._break_if_stale()
            if time.perf_counter() > deadline:
                raise TimeoutError(f"lock {self.name!r} contended for "
                                   f"{timeout_s}s")
            time.sleep(poll_s)

    def _read_stamp(self):
        """(pid, acquire-time) from the current segment, or None if gone."""
        try:
            seg = shared_memory.SharedMemory(self.name, create=False)
        except FileNotFoundError:
            return None                 # holder released between our attempts
        except ValueError:
            # raced the creator between shm_open and ftruncate: the segment
            # exists but is still empty (mmap of size 0) — treat as "stamp
            # not readable yet", i.e. a fresh, non-stale holder
            return None
        try:
            return struct.unpack_from(self._STAMP_FMT, seg.buf, 0)
        except struct.error:
            return None
        finally:
            seg.close()

    def _break_if_stale(self) -> None:
        stamp = self._read_stamp()
        if stamp is None or not stamp[1] or \
                time.time() - stamp[1] <= self.stale_s:
            return
        # revalidate on a fresh handle right before unlinking: the name may
        # now belong to a segment another breaker just re-created (unlink
        # removes by NAME, not the inode we inspected)
        try:
            seg = shared_memory.SharedMemory(self.name, create=False)
        except (FileNotFoundError, ValueError):
            return                      # gone, or re-created mid-ftruncate
        try:
            if struct.unpack_from(self._STAMP_FMT, seg.buf, 0) == stamp:
                seg.unlink()            # holder presumed dead
        except (struct.error, FileNotFoundError):
            pass
        finally:
            seg.close()

    def release(self) -> None:
        """Drop the lock (idempotent)."""
        if self._held is not None:
            held, self._held = self._held, None
            held.close()
            try:
                held.unlink()
            except FileNotFoundError:
                pass

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class SharedMemoryArena:
    """One named, pre-mapped shared-memory segment with a validated header."""

    def __init__(self, name: str, size: int = 0, create: bool = False,
                 pre_touch: bool = True):
        self.name = name
        self.is_creator = create
        if create:
            total = HEADER_REGION + size
            self._shm = shared_memory.SharedMemory(
                name=name, create=True, size=total)
            if pre_touch:
                # first-touch every page now so the data path never faults;
                # memset through a view (no arena-sized bytes temporary)
                view = np.frombuffer(self._shm.buf, np.uint8)
                view[:] = 0
                del view
            struct.pack_into(_HEADER_FMT, self._shm.buf, 0,
                             MAGIC, VERSION, total, HEADER_REGION)
        else:
            self._shm = shared_memory.SharedMemory(name=name, create=False)
            magic, version, total, user_off = struct.unpack_from(
                _HEADER_FMT, self._shm.buf, 0)
            if magic != MAGIC:
                raise ValueError(f"{name}: not a ROCKET arena (magic "
                                 f"{magic:#x})")
            if version != VERSION:
                raise ValueError(f"{name}: arena version {version} != "
                                 f"{VERSION}")
        self._user_offset = HEADER_REGION
        self._closed = False

    # -- views ---------------------------------------------------------------
    @property
    def buf(self) -> memoryview:
        """The raw mapped segment (header + control words + user region)."""
        return self._shm.buf

    @property
    def size(self) -> int:
        """Bytes available in the user region."""
        return len(self._shm.buf) - self._user_offset

    def control_words(self) -> np.ndarray:
        """The int64 control-word table (shared cursors/flags)."""
        return np.frombuffer(self._shm.buf, np.int64,
                             count=N_CONTROL_WORDS, offset=64)

    def seqlock(self, word_index: int) -> SeqLock:
        """A :class:`SeqLock` over the given control word."""
        words = self.control_words()
        return SeqLock(words[word_index:word_index + 1])

    def view(self, offset: int, nbytes: int) -> memoryview:
        """A memoryview into the user region at ``offset``."""
        start = self._user_offset + offset
        if start + nbytes > len(self._shm.buf):
            raise ValueError(
                f"view [{offset}, {offset + nbytes}) exceeds arena user "
                f"region of {self.size} bytes")
        return self._shm.buf[start:start + nbytes]

    def ndarray(self, offset: int, shape, dtype) -> np.ndarray:
        """A typed zero-copy numpy view into the user region."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        return np.frombuffer(self.view(offset, nbytes), dtype).reshape(shape)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Unmap the segment from this process (unlink destroys it)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except BufferError:
            # a numpy view into the segment is still alive somewhere; collect
            # dropped references and retry once before giving up loudly
            import gc
            gc.collect()
            self._shm.close()

    def unlink(self) -> None:
        """Destroy the segment (creator-side, after both ends closed)."""
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        if self.is_creator:
            self.unlink()


def attach_retry(name: str, timeout_s: float = 10.0,
                 interval_s: float = 0.01) -> SharedMemoryArena:
    """Attach to an arena that a peer process may not have created yet.

    A ValueError (bad magic/version) is also retried within the window: the
    segment becomes visible before the creator finishes pre-touching and
    writing the header, so an early attacher can read zeros where the magic
    belongs.  Only at the deadline is it surfaced as a real mismatch.
    """
    deadline = time.perf_counter() + timeout_s
    while True:
        try:
            return SharedMemoryArena(name, create=False)
        except FileNotFoundError:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"arena {name!r} never appeared")
        except ValueError:
            if time.perf_counter() > deadline:
                raise
        time.sleep(interval_s)

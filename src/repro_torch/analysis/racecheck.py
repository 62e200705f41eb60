"""Eraser-style lockset race detection for the threaded transport.

:class:`RaceChecker` instruments ``FifoChannel`` / ``Network`` / ``Proxy``
instances created while it is installed: their concurrency-relevant scalar
fields are tracked per attribute access, their locks are replaced with
recording wrappers, and every access is fed through the classic Eraser
state machine (Savage et al. 1997) with two refinements the transport's
intentional lock-free patterns require:

- **exclusive phase**: a variable touched by only one thread so far is
  never refined (initialization happens before sharing);
- **sole-writer reads**: a read by the *only* thread that has ever written
  the variable is exempt (the SPSC ring's producer reads its own ``_tail``
  and ``_cached_head`` locklessly by design — the consumer never writes
  them, so those reads race nothing).

A variable whose candidate lockset empties while it has at least one
writer and at least two accessing threads is reported as a candidate race.
Instrumentation is attribute-level: in-place mutation of tracked
containers (``buf[i] = ...``, ``stats["k"] += 1``) is invisible — only
rebinding writes are seen.  That is the right granularity for the
transport's contract (counters and flags are rebound; arrays are owned by
one side per slot), and it is what keeps the shipped threaded path at
zero findings while a seeded lock-removal mutant is flagged.

Usage::

    with RaceChecker() as rc:
        w = EPWorld(..., use_threads=True)
        w.run(...)
    assert rc.findings() == []

The context manager monkeypatches the three constructors on entry and
restores them on exit; objects created outside the window are untouched.
The port of ``repro.analysis.racecheck``, over the port's transport.
"""
from __future__ import annotations

import threading
from typing import Optional

from repro_torch.analysis.invariants import Finding
from repro_torch.core.transport import fifo as _fifo
from repro_torch.core.transport import proxy as _proxy
from repro_torch.core.transport import simulator as _sim

# concurrency-relevant *rebound* scalar fields per class (containers that
# are mutated in place — buf, stats, _seq, ctrl, heaps — are attribute-
# stable and deliberately not trackable at this granularity)
TRACKED_FIELDS = {
    "FifoChannel": frozenset({"_head", "_tail", "_cached_head",
                              "_pcie_reads", "closed"}),
    "Network": frozenset({"clock_us", "_order", "delivered", "bytes_moved",
                          "hdr_bytes_moved", "coalesced_msgs",
                          "coalesced_writes", "_jit", "_jit_pos"}),
    "Proxy": frozenset({"_executing", "error"}),
}


class TrackedLock:
    """A ``threading.Lock`` stand-in that records acquire/release with the
    checker.  Duck-types everything ``threading.Condition`` needs
    (``acquire``/``release``/``_is_owned``), so conditions built on it
    keep working — and their internal waiter juggling is recorded too."""

    __slots__ = ("_lk", "_ck", "name")

    def __init__(self, checker: "RaceChecker", name: str):
        self._lk = threading.Lock()
        self._ck = checker
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._ck._push_lock(self.name)
        return ok

    def release(self):
        self._ck._pop_lock(self.name)
        self._lk.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._lk.locked()

    def _is_owned(self):
        # Condition's ownership probe for non-RLocks: try-acquire without
        # recording (same fallback CPython uses when the primitive lacks
        # _is_owned)
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True


class _VarState:
    """Eraser state for one (object, field) variable."""

    __slots__ = ("owner", "shared", "writers", "threads", "lockset",
                 "reported", "last")

    def __init__(self, owner: int):
        self.owner = owner          # first-accessing thread (exclusive phase)
        self.shared = False
        self.writers: set[int] = set()
        self.threads: set[int] = {owner}
        self.lockset: Optional[frozenset] = None   # None = ⊤ (not yet shared)
        self.reported = False
        self.last = ""


class RaceChecker:
    """Install with ``with RaceChecker() as rc:`` (or ``install()`` /
    ``uninstall()``); read candidate races via :meth:`findings`."""

    def __init__(self):
        self._guard = threading.Lock()        # leaf lock for checker state
        self._tl = threading.local()
        self._vars: dict[tuple[int, str], _VarState] = {}
        self._labels: dict[int, str] = {}
        self._findings: list[Finding] = []
        self._orig: list[tuple] = []
        self._subclass_cache: dict[type, type] = {}
        self._counter = 0
        self._active = False

    # ------------------------------------------------------ lock tracking --
    def _held(self) -> tuple:
        return tuple(getattr(self._tl, "held", ()))

    def _push_lock(self, name: str) -> None:
        held = getattr(self._tl, "held", None)
        if held is None:
            held = []
            self._tl.held = held
        held.append(name)

    def _pop_lock(self, name: str) -> None:
        held = getattr(self._tl, "held", None)
        if held and name in held:
            held.reverse()
            held.remove(name)
            held.reverse()

    # -------------------------------------------------------- state machine --
    def record_access(self, var: tuple[int, str], thread: int,
                      held: frozenset, write: bool,
                      where: str = "") -> None:
        """Feed one access through the Eraser state machine.  Public so the
        unit tests can drive synthetic traces deterministically."""
        with self._guard:
            st = self._vars.get(var)
            if st is None:
                st = _VarState(thread)
                self._vars[var] = st
            st.threads.add(thread)
            if write:
                st.writers.add(thread)
            if not st.shared:
                if thread == st.owner:
                    return              # exclusive phase: no refinement
                st.shared = True        # second thread arrives: lockset = ⊤
            # reads race nothing until a write exists (refining from a
            # pre-first-write lockless read would poison the lockset), and
            # the sole writer's own reads are exempt (the SPSC ring's
            # producer-owned counters are read locklessly by design)
            if not write and (not st.writers or st.writers == {thread}):
                return
            st.lockset = held if st.lockset is None \
                else st.lockset & held
            st.last = where
            if (not st.lockset and st.writers and len(st.threads) >= 2
                    and not st.reported):
                st.reported = True
                obj_id, field = var
                label = self._labels.get(obj_id, f"obj{obj_id}")
                kind = "write" if write else "read"
                self._findings.append(Finding(
                    "RACE-LOCKSET",
                    f"{label}.{field}: candidate race — lockset empty after "
                    f"unsynchronized {kind} ({len(st.threads)} threads, "
                    f"{len(st.writers)} writer(s))",
                    where=(label, field)))

    def _record(self, obj_id: int, field: str, write: bool) -> None:
        if not self._active:
            return
        self.record_access((obj_id, field), threading.get_ident(),
                           frozenset(self._held()), write)

    def findings(self) -> list[Finding]:
        with self._guard:
            return list(self._findings)

    # ------------------------------------------------------ instrumentation --
    def _instrumented_class(self, cls: type) -> type:
        sub = self._subclass_cache.get(cls)
        if sub is not None:
            return sub
        tracked = TRACKED_FIELDS[cls.__name__]
        checker = self

        class Instrumented(cls):
            def __getattribute__(self, name):
                if name in tracked:
                    checker._record(id(self), name, write=False)
                return object.__getattribute__(self, name)

            def __setattr__(self, name, value):
                if name in tracked:
                    checker._record(id(self), name, write=True)
                object.__setattr__(self, name, value)

        Instrumented.__name__ = cls.__name__ + "·traced"
        self._subclass_cache[cls] = Instrumented
        return Instrumented

    def instrument(self, obj, label: Optional[str] = None,
                   strip_locks: bool = False) -> None:
        """Attach tracking to one FifoChannel/Network/Proxy instance:
        replace its lock(s) with :class:`TrackedLock`s (rebuilding any
        Conditions on them) and swap in the field-recording subclass.

        ``strip_locks=True`` installs *non-recording* plain locks instead —
        the seeded lock-removal mutant: the code still synchronizes (no
        real corruption in the test process) but the checker can no longer
        see the lock, exactly as if the ``with self._lock:`` were deleted.
        """
        cls = type(obj)
        base = cls.__name__.split("·")[0]
        self._counter += 1
        if label is None:
            label = f"{base}#{self._counter}"
        self._labels[id(obj)] = label

        def mklock(name):
            return threading.Lock() if strip_locks \
                else TrackedLock(self, f"{label}.{name}")

        if base == "FifoChannel":
            lk = mklock("_lock")
            obj._lock = lk
            obj._not_full = threading.Condition(lk)
            obj._not_empty = threading.Condition(lk)
        elif base == "Network":
            if obj._lock is not None:
                obj._lock = mklock("_lock")
        elif base == "Proxy":
            obj._lock = mklock("_lock")
        else:
            raise TypeError(f"cannot instrument {cls.__name__}")
        # swap the class last: the lock surgery above must not be recorded
        obj.__class__ = self._instrumented_class(
            cls if "·" not in cls.__name__ else cls.__mro__[1])

    # ------------------------------------------------- constructor patching --
    def install(self) -> "RaceChecker":
        """Monkeypatch the three constructors so every instance created
        while installed is instrumented (FIFO channels created inside
        Proxy.__init__ included — the FifoChannel patch sees them)."""
        checker = self

        def wrap(cls):
            orig = cls.__init__

            def __init__(self_, *a, **k):
                orig(self_, *a, **k)
                checker.instrument(self_)

            self._orig.append((cls, orig))
            cls.__init__ = __init__

        wrap(_fifo.FifoChannel)
        wrap(_sim.Network)
        wrap(_proxy.Proxy)
        self._active = True
        return self

    def uninstall(self) -> None:
        self._active = False
        for cls, orig in self._orig:
            cls.__init__ = orig
        self._orig.clear()

    __enter__ = install

    def __exit__(self, *exc) -> None:
        self.uninstall()

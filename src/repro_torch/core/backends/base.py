"""Simulated external-cluster machinery: the server side of a resource manager.

The port's own copy of the server half of ``repro.core.backends.base``: the
canonical job states, ``ClusterJob``, the ``Payload`` contract and
``SimulatedCluster`` -- a queue of jobs, a bounded set of execution slots, a
scheduler thread that advances job states, the events version and ring that
watch routes long-poll, and the serve-mode surface (health and invoke).  A
REST dialect (``backends/slurm.py``) exposes it; ``backends/jaxlocal.py``
gives it its payload, PyTorch training and serving runs.

What only the Bridge uses (``Capability``, ``ResourceAdapter``,
``resolve_adapter``, ``normalized_queue_load``, ``SubmitError``,
``InvokeError``) stays in ``repro.core`` and is not copied.  Nor are the
reference's default payload (the sleep payload and its echo serve loop),
power-off and the file staging area: a jaxlocal cluster always has its own
payload, and its slurm dialect has no file routes.

Canonical internal states (each dialect maps to its own vocabulary):
    QUEUED -> RUNNING -> {COMPLETED, FAILED, CANCELLED}
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

QUEUED = "QUEUED"
RUNNING = "RUNNING"
COMPLETED = "COMPLETED"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
TERMINAL = (COMPLETED, FAILED, CANCELLED)


@dataclass
class ClusterJob:
    id: str
    script: str
    properties: Dict[str, str] = field(default_factory=dict)
    params: Dict[str, str] = field(default_factory=dict)
    state: str = QUEUED
    submit_time: float = field(default_factory=time.time)
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    exit_code: Optional[int] = None
    reason: str = ""
    # cluster events version at this job's last state transition (watch/
    # long-poll support: lets a watcher ask "did THESE ids change since v?")
    events_stamp: int = 0
    # files produced by the job (a train job's ``train.out``)
    outputs: Dict[str, bytes] = field(default_factory=dict)
    # serve-mode jobs (long-lived replicas): the payload installs a request
    # handler once it can take traffic — health answers 200 iff the job is
    # RUNNING with a handler installed and not flagged unhealthy
    handler: Optional[Callable[[Any], Any]] = field(default=None, repr=False)
    unhealthy: threading.Event = field(default_factory=threading.Event,
                                       repr=False)
    invocations: int = 0
    _cancel: threading.Event = field(default_factory=threading.Event, repr=False)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "id": self.id, "state": self.state, "submit_time": self.submit_time,
            "start_time": self.start_time, "end_time": self.end_time,
            "exit_code": self.exit_code, "reason": self.reason,
        }


# A payload executes the job body.  It runs on a worker thread and must poll
# ``job._cancel`` to honour kills.  Returns an exit code.
Payload = Callable[[ClusterJob, "SimulatedCluster"], int]


class SimulatedCluster:
    """Bounded-slot job executor with a scheduler thread."""

    def __init__(self, name: str, payload: Payload, slots: int = 4,
                 id_prefix: str = "", start_numbering: int = 1000):
        self.name = name
        self.slots = slots
        self.payload = payload
        self.id_prefix = id_prefix
        self.jobs: Dict[str, ClusterJob] = {}
        self._next_id = start_numbering
        self._lock = threading.RLock()
        # monotonically increasing events version: bumped (under the lock)
        # on EVERY job state transition; watchers long-poll it via the
        # condition so a ``GET /jobs/events?since=`` wakes on the change
        self._events_version = 0
        self._events_cv = threading.Condition(self._lock)
        # bounded event ring: (version, job_id, canonical_state) per bump,
        # job_id None for job-less bumps (shutdown).  Lets a watcher ask
        # "WHAT changed since v", not just "did anything change"; when the
        # ring no longer covers ``since`` the payload answer degrades to
        # "unknown" and consumers fall back to a status poll
        self._events_ring: "deque[Tuple[int, Optional[str], str]]" = deque(
            maxlen=4096)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._sched = threading.Thread(target=self._schedule_loop, daemon=True,
                                       name=f"{name}-sched")
        self._sched.start()

    # -- events version (watch/long-poll substrate) -------------------------

    def _bump_events(self, job: Optional[ClusterJob] = None) -> None:
        """Publish one state transition to watchers.  Caller holds _lock."""
        self._events_version += 1
        if job is not None:
            job.events_stamp = self._events_version
        self._events_ring.append((self._events_version,
                                  job.id if job is not None else None,
                                  job.state if job is not None else ""))
        self._events_cv.notify_all()

    def events_version(self) -> int:
        with self._lock:
            return self._events_version

    def wait_events(self, since: int, timeout: float = 0.0,
                    ids: Optional[List[str]] = None) -> "tuple[int, bool]":
        """Long-poll primitive: block until an event relevant to ``ids``
        (any event when ``ids`` is None; a vanished id counts as changed)
        is newer than ``since``, or ``timeout`` elapses.  Returns
        (current global version, relevant_change_seen)."""
        def relevant() -> bool:
            if ids is None:
                return self._events_version > since
            return any(j is None or j.events_stamp > since
                       for j in (self.jobs.get(i) for i in ids))

        deadline = time.time() + max(timeout, 0.0)
        with self._events_cv:
            changed = relevant()
            while not changed:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._events_cv.wait(remaining)
                changed = relevant()
            return self._events_version, changed

    def wait_events_payload(self, since: int, timeout: float = 0.0,
                            ids: Optional[List[str]] = None
                            ) -> "tuple[int, bool, Optional[List[Tuple[str, str]]]]":
        """``wait_events`` plus the WHAT: returns (version, changed, events)
        where ``events`` lists ``(job_id, state)`` for every relevant
        transition in ``(since, version]`` — deduplicated, latest state per
        id — or None when the bounded ring no longer covers that range (or a
        job-less wildcard bump falls inside it), meaning the caller must
        re-poll statuses instead of trusting the enumeration."""
        version, changed = self.wait_events(since, timeout, ids)
        if not changed:
            return version, False, []
        with self._lock:
            return self._events_version, True, self._events_payload(since, ids)

    def _events_payload(self, since: int,
                        ids: Optional[List[str]]) -> Optional[List[Tuple[str, str]]]:
        """Enumerate ring events newer than ``since`` (caller holds _lock).
        None == coverage unknown."""
        ring = self._events_ring
        if not ring or ring[0][0] > max(since, 0) + 1:
            # the ring starts after ``since``: overwritten entries may hide
            # transitions we can no longer enumerate
            return None
        latest: Dict[str, str] = {}
        for version, jid, state in ring:
            if version <= since:
                continue
            if jid is None:
                return None  # wildcard bump: scope unknown
            latest[jid] = state
        if ids is not None:
            want = set(ids)
            return [(j, s) for j, s in latest.items() if j in want]
        return list(latest.items())

    # -- control surface (what REST facades call) ---------------------------

    def submit(self, script: str, properties: Dict[str, str],
               params: Dict[str, str]) -> ClusterJob:
        with self._lock:
            jid = f"{self.id_prefix}{self._next_id}"
            self._next_id += 1
            job = ClusterJob(id=jid, script=script, properties=dict(properties or {}),
                             params=dict(params or {}))
            self.jobs[jid] = job
            self._bump_events(job)
            return job

    def get(self, job_id: str) -> Optional[ClusterJob]:
        with self._lock:
            return self.jobs.get(job_id)

    def cancel(self, job_id: str) -> bool:
        return self.cancel_if_live(job_id) != "absent"

    def cancel_if_live(self, job_id: str) -> str:
        """Cancel with the state race resolved ATOMICALLY under the lock:
        returns "absent", "terminal" (the job finished before the cancel
        landed — REST facades answer 409 Conflict, not 500), or "cancelled".
        """
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return "absent"
            if job.state in TERMINAL:
                return "terminal"
            if job.state == QUEUED:
                job.state = CANCELLED
                job.end_time = time.time()
                self._bump_events(job)
                return "cancelled"
        job._cancel.set()
        return "cancelled"

    # -- serve-mode surface (health + invoke, shared by the REST dialects) --

    def serve_health(self, job_id: str) -> "tuple[int, Dict[str, Any]]":
        """(http_status, body) for a replica health probe: 200 iff the job is
        RUNNING with its handler installed and not flagged unhealthy."""
        job = self.get(job_id)
        if job is None:
            return 404, {"error": f"job {job_id} not found"}
        if (job.state != RUNNING or job.handler is None
                or job.unhealthy.is_set()):
            return 503, {"status": "unready", "state": job.state}
        return 200, {"status": "ok", "state": job.state}

    def serve_invoke(self, job_id: str, body: Any) -> "tuple[int, Any]":
        """(http_status, response_body) for one request to a replica.  The
        handler runs OUTSIDE the cluster lock — requests are the data plane
        and must not serialize against the scheduler."""
        job = self.get(job_id)
        if job is None:
            return 404, {"error": f"job {job_id} not found"}
        handler = job.handler
        if job.state != RUNNING or handler is None or job.unhealthy.is_set():
            return 503, {"error": "replica unready", "state": job.state}
        with self._lock:
            job.invocations += 1
        try:
            return 200, handler(body)
        except Exception as e:
            return 500, {"error": f"{type(e).__name__}: {e}"}

    def queue_load(self) -> Dict[str, int]:
        with self._lock:
            q = sum(1 for j in self.jobs.values() if j.state == QUEUED)
            r = sum(1 for j in self.jobs.values() if j.state == RUNNING)
        return {"queued": q, "running": r, "slots": self.slots}

    def shutdown(self) -> None:
        self._stop.set()
        for j in list(self.jobs.values()):
            j._cancel.set()
        with self._lock:
            self._bump_events()  # release any in-flight long-poll waiters
        self._sched.join(timeout=2)

    # -- scheduler --------------------------------------------------------

    def _schedule_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                # reap finished workers — the list must not grow with job count
                self._threads = [t for t in self._threads if t.is_alive()]
                running = sum(1 for j in self.jobs.values() if j.state == RUNNING)
                to_start = [j for j in sorted(self.jobs.values(),
                                              key=lambda j: j.submit_time)
                            if j.state == QUEUED][:max(self.slots - running, 0)]
                for job in to_start:
                    job.state = RUNNING
                    job.start_time = time.time()
                    self._bump_events(job)
                    t = threading.Thread(target=self._run_job, args=(job,),
                                         daemon=True, name=f"{self.name}-{job.id}")
                    self._threads.append(t)
                    t.start()
            time.sleep(0.005)

    def _run_job(self, job: ClusterJob) -> None:
        try:
            code = self.payload(job, self)
        except Exception as e:  # payload crash == job failure
            job.reason = f"{type(e).__name__}: {e}"
            code = 1
        with self._lock:
            job.exit_code = code
            job.end_time = time.time()
            if job._cancel.is_set() or code == -1:
                job.state = CANCELLED
            elif code == 0:
                job.state = COMPLETED
            else:
                job.state = FAILED
            self._bump_events(job)

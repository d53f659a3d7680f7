"""The server side of the simulated HTTP/HTTPS transport.

The port's own copy of the server half of ``repro.core.rest`` (the port
imports nothing of the JAX package): ``HttpResponse`` and ``RestServer``,
with the same route table, bearer-token auth, per-route counters,
query-string merging and ``watch`` routes (a handler that may block until a
state version advances or its wait budget, capped by the client's timeout,
runs out and it answers 204).  A resource manager of the
port serves its REST dialect through it.

The client side (``Channel``, ``RestClient``, ``ResourceManagerDirectory``)
belongs to the Bridge and is not copied: the Bridge of ``repro.core``
reaches a server of the port through ``handle``, which has the reference's
signature.  The reference's ``TransportError`` and ``FaultProfile`` are not
copied either: the Bridge recognises a network fault by the reference's
class, so faults are injected only on the Bridge's side of the wire, with
the reference's ``FaultProfile`` in front of this server (ROADMAP.md,
"Rules of the port").
"""
from __future__ import annotations

import math
import re
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl


@dataclass
class HttpResponse:
    status: int
    json: Any = None

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


Handler = Callable[[Dict[str, str], Any], HttpResponse]
# watch handlers additionally receive the wait budget (seconds) the server
# grants them: min(what the query asked for, what the client will wait)
WatchHandler = Callable[[Dict[str, str], Any, float], HttpResponse]


class RestServer:
    """Route table + bearer-token auth for one simulated resource manager."""

    def __init__(self, token: str = ""):
        self._routes: List[Tuple[str, re.Pattern, Handler, str, str]] = []
        self._token = token
        self.request_count = 0
        self._lock = threading.Lock()
        # per-route request/error counters, keyed "METHOD /pattern"
        self._stats: Dict[str, Dict[str, int]] = {}

    def route(self, method: str, pattern: str, handler: Handler,
              kind: str = "plain") -> None:
        """pattern: '/jobs/{id}' -> named groups.  ``kind="watch"`` marks a
        long-poll route: its handler gets a third argument (the wait budget
        in seconds) and may block until a state-version advances or the
        budget runs out (answering 204)."""
        if kind not in ("plain", "watch"):
            raise ValueError(f"unknown route kind {kind!r}")
        rx = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
        self._routes.append((method.upper(), rx, handler, kind, pattern))

    @property
    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-route {"requests", "errors"} counters (copy)."""
        with self._lock:
            return {k: dict(v) for k, v in self._stats.items()}

    def _count(self, key: str, error: bool) -> None:
        with self._lock:
            ent = self._stats.setdefault(key, {"requests": 0, "errors": 0})
            ent["requests"] += 1
            if error:
                ent["errors"] += 1

    def handle(self, method: str, path: str, json_body: Any = None,
               headers: Optional[Dict[str, str]] = None,
               timeout: Optional[float] = None) -> HttpResponse:
        # ``timeout`` is the client's: watch routes cap their blocking wait
        # to it below
        with self._lock:
            self.request_count += 1
        headers = headers or {}
        if self._token:
            auth = headers.get("Authorization", "")
            if auth != f"Bearer {self._token}":
                self._count("(unauthorized)", error=True)
                return HttpResponse(401, {"error": "unauthorized"})
        # query string: merged into the handler's groups dict (path groups
        # win on collision), so 'GET /jobs?ids=a,b' routes like 'GET /jobs'
        path, _, query = path.partition("?")
        params = dict(parse_qsl(query)) if query else {}
        for m, rx, handler, kind, pattern in self._routes:
            if m != method.upper():
                continue
            match = rx.match(path)
            if match:
                key = f"{m} {pattern}"
                try:
                    if kind == "watch":
                        budget = math.inf if timeout is None else timeout
                        resp = handler({**params, **match.groupdict()},
                                       json_body, budget)
                    else:
                        resp = handler({**params, **match.groupdict()},
                                       json_body)
                except Exception as e:  # backend bug -> 500, not a crash
                    resp = HttpResponse(500,
                                        {"error": f"{type(e).__name__}: {e}"})
                self._count(key, error=resp.status >= 400)
                return resp
        self._count("(unmatched)", error=True)
        return HttpResponse(404, {"error": f"no route {method} {path}"})

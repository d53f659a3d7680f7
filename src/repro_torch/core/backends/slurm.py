"""Simulated slurmrestd (REST dialect per Slurm's v0.0.37-era API): the server.

The port's own copy of the server half of ``repro.core.backends.slurm``: the
state map and ``make_server`` with all nine routes (submit, with ``sbatch
--array`` fan-out; job, multi-id jobs, events long-poll, health, invoke,
cancel, ping, partitions), the same statuses and JSON keys.  The Bridge's
``SlurmAdapter`` stays in ``repro.core`` and drives this server unchanged.

Dialect notes (paper §5.2): numeric job ids; sacct-style states; the Slurm
REST API tested in the paper (21.08) does NOT support file upload/download.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.backends import base as B
from repro_torch.core.rest import HttpResponse, RestServer

_STATE_TO_SLURM = {
    B.QUEUED: "PENDING",
    B.RUNNING: "RUNNING",
    B.COMPLETED: "COMPLETED",
    B.FAILED: "FAILED",
    B.CANCELLED: "CANCELLED",
}


def make_server(cluster: B.SimulatedCluster, token: str = "") -> RestServer:
    srv = RestServer(token=token)

    def submit(_groups, body) -> HttpResponse:
        body = body or {}
        if "script" not in body:
            return HttpResponse(400, {"error": "no script"})
        # sbatch --array analogue: one request fans out N tasks, each a full
        # job with SLURM_ARRAY_TASK_ID and optional per-index params;
        # array_start offsets the task ids (sbatch --array=lo-hi), which is
        # how a placement slice submits its global index range in one call
        n = int(body.get("array_size", 0) or 0)
        if n > 1:
            per_index = body.get("params_by_index") or []
            base = int(body.get("array_start", 0) or 0)
            task_ids = []
            for i in range(n):
                params = dict(body.get("params", {}))
                if i < len(per_index):
                    params.update(per_index[i])
                params.setdefault("SLURM_ARRAY_TASK_ID", str(base + i))
                job = cluster.submit(body["script"], body.get("job", {}),
                                     params)
                task_ids.append(int(job.id))
            return HttpResponse(200, {"job_id": task_ids[0],
                                      "task_ids": task_ids})
        job = cluster.submit(body["script"], body.get("job", {}),
                             body.get("params", {}))
        return HttpResponse(200, {"job_id": int(job.id)})

    def _job_record(job: B.ClusterJob) -> dict:
        s = job.snapshot()
        return {
            "job_id": int(job.id),
            "job_state": _STATE_TO_SLURM[job.state],
            "start_time": s["start_time"], "end_time": s["end_time"],
            "exit_code": s["exit_code"], "state_reason": s["reason"],
        }

    def get_job(groups, _body) -> HttpResponse:
        job = cluster.get(groups["id"])
        if job is None:
            return HttpResponse(404, {"error": "job not found"})
        return HttpResponse(200, {"jobs": [_job_record(job)]})

    def get_jobs(groups, _body) -> HttpResponse:
        # squeue -j id1,id2 analogue: one request answers many ids; an id
        # slurmctld no longer knows yields a record with job_state=null
        ids = [s for s in groups.get("ids", "").split(",") if s]
        if not ids:
            return HttpResponse(400, {"error": "ids query param required"})
        records = []
        for jid in ids:
            job = cluster.get(jid)
            records.append(_job_record(job) if job is not None
                           else {"job_id": jid, "job_state": None})
        return HttpResponse(200, {"jobs": records})

    def cancel(groups, _body) -> HttpResponse:
        # scancel of an already-finished job: 409 Conflict (the cancel lost
        # the race against the terminal transition), never a 500
        outcome = cluster.cancel_if_live(groups["id"])
        if outcome == "absent":
            return HttpResponse(404, {"error": "job not found"})
        if outcome == "terminal":
            return HttpResponse(409, {"error": "job already terminal"})
        return HttpResponse(200, {})

    def events(groups, _body, budget) -> HttpResponse:
        # long-poll watch: answer as soon as an event relevant to ``ids``
        # (any event without ids) is newer than ``since``; 204 when nothing
        # changed within min(wait, client timeout) — "no content" is the
        # cheap steady-state answer that lets a watcher skip its status poll
        since = int(groups.get("since", "-1") or -1)
        ids = [s for s in groups.get("ids", "").split(",") if s] or None
        wait = min(float(groups.get("wait", "0") or 0), budget)
        version, changed, payload = cluster.wait_events_payload(
            since, timeout=wait, ids=ids)
        if not changed:
            return HttpResponse(204)
        body: Dict[str, Any] = {"version": version}
        if payload is not None:
            # WHICH jobs changed, in dialect vocabulary; omitted when the
            # cluster's bounded event ring no longer covers ``since`` (the
            # client must re-poll statuses instead)
            body["events"] = [{"job_id": int(jid),
                               "job_state": _STATE_TO_SLURM[state]}
                              for jid, state in payload]
        return HttpResponse(200, body)

    def health(groups, _body) -> HttpResponse:
        status, payload = cluster.serve_health(groups["id"])
        return HttpResponse(status, payload)

    def invoke(groups, body) -> HttpResponse:
        status, payload = cluster.serve_invoke(groups["id"], body)
        return HttpResponse(status, payload)

    def ping(_groups, _body) -> HttpResponse:
        return HttpResponse(200, {"pings": [{"ping": "UP"}]})

    def partitions(_groups, _body) -> HttpResponse:
        load = cluster.queue_load()
        return HttpResponse(200, {"partitions": [dict(name="batch", **load)]})

    srv.route("POST", "/slurm/v0.0.37/job/submit", submit)
    srv.route("GET", "/slurm/v0.0.37/jobs/events", events, kind="watch")
    srv.route("GET", "/slurm/v0.0.37/jobs", get_jobs)
    srv.route("GET", "/slurm/v0.0.37/job/{id}/health", health)
    srv.route("POST", "/slurm/v0.0.37/job/{id}/invoke", invoke)
    srv.route("GET", "/slurm/v0.0.37/job/{id}", get_job)
    srv.route("DELETE", "/slurm/v0.0.37/job/{id}", cancel)
    srv.route("GET", "/slurm/v0.0.37/ping", ping)
    srv.route("GET", "/slurm/v0.0.37/partitions", partitions)
    return srv

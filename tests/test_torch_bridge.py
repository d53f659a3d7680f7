"""The port's ``jaxlocal`` resource manager (``repro_torch.core``) against the
reference's (``repro.core.backends.jaxlocal``), on the CPU at smoke size:
the train job's losses, its crash and resume, the serve job's greedy tokens,
every route of the slurm REST dialect, and the refusal to run without a card
unless ``device="cpu"`` is passed.  Then the unmodified Bridge
(``repro.core``) driving the twin as it drives the reference: the learn and
crash-and-resume runs of ``tests/test_e2e_training.py``, the two-replica
serving scenario of ``examples/model_serving.py`` (one replica killed
mid-traffic, no request lost), and a job that reaches DONE through injected
network faults.

Params are made by the JAX package (``repro.steps.init_model``) and carried
into the twin with ``params_from_numpy``, by patching each module's
``init_model`` in the test only.  Tolerance: 2e-4 relative for every loss.

The twin is swapped into a ``BridgeEnvironment`` before its operator starts
(``_twin_env``): the environment's reference jaxlocal cluster is shut down
and replaced, and the twin's server is registered under the same URL, so the
directory's one channel for that URL holds the twin's server.  Faults are
injected on the Bridge's side of the wire, by ``_Wire`` with the reference's
``FaultProfile``, so the Bridge sees them as its own ``TransportError``.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import (BridgeEnvironment, DONE, FAILED, HealthProbeSpec, IMAGES,
                        PlacementCandidate, PlacementSpec, RUNNING, TOKENS, URLS)
from repro.core.backends import jaxlocal as JJX
from repro.core.objectstore import ObjectStore as JObjectStore
from repro.core.rest import FaultProfile, TransportError
from repro_torch.core import ObjectStore
from repro_torch.core.backends import jaxlocal as TJX
from repro_torch.models.params import params_from_numpy

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = 2e-4
TOKEN = "tok-0123"
AUTH = {"Authorization": f"Bearer {TOKEN}"}
SLURM = "/slurm/v0.0.37"
TRAIN = {"arch": "gemma-2b", "batch": 2, "seq": 16, "lr": 1e-2}
SERVE = {"mode": "serve", "arch": "gemma-2b", "max_batch": 2, "max_len": 32,
         "prefill_len": 8, "seed": 0}


def _tame(jp, jcfg):
    """wq and wk rescaled to std 1/sqrt(d_model), so the attention scores are
    O(1) (``tests/test_torch_train.py::_tame``): under the reference's init
    the scores run in the hundreds and ten steps of two correct
    implementations drift apart by ~2e-4."""
    attn = dict(jp["blocks"]["attn"])
    for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
        attn[name] = attn[name] * np.sqrt(heads / jcfg.d_model)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


def _carry_params(monkeypatch, arch="gemma-2b", seed=0):
    """Both modules' jobs draw the same params: the reference's (tamed), made
    once, handed to its jobs as they are and to the twin's as fresh torch
    copies (the twin's train step updates its params in place)."""
    jcfg = j_smoke(arch)
    _, jp = JS.init_model(jcfg, seed=seed, max_seq=16)
    jp = _tame(jp, jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    monkeypatch.setattr(JS, "init_model", lambda cfg, seed=0, max_seq=128: (None, jp))
    monkeypatch.setattr(TJX, "init_model", lambda cfg, seed=0, max_seq=128, device="cuda":
                        (None, params_from_numpy(host, device)))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _ref(spec, **kw):
    return JJX.train_job(spec, kw.pop("store", None) or JObjectStore(), **kw)


def _twin(spec, **kw):
    return TJX.train_job(spec, kw.pop("store", None) or ObjectStore(), device="cpu", **kw)


# -- the train job ----------------------------------------------------------------------


def test_train_job_losses_match_the_reference(monkeypatch):
    _carry_params(monkeypatch)
    spec = dict(TRAIN, steps=8)
    want, got = _ref(spec), _twin(spec)
    assert _rel(got["history"], want["history"]) <= TOL
    for key in ("state", "step", "start_step"):
        assert got[key] == want[key]
    assert got["final_loss"] == got["history"][-1]


def test_train_job_logs_and_cancels_as_the_reference():
    spec = dict(TRAIN, steps=2)
    logs = {"ref": [], "twin": []}
    _ref(spec, log=logs["ref"])
    _twin(spec, log=logs["twin"])
    assert [s for s, _ in logs["twin"]] == [s for s, _ in logs["ref"]] == [0, 1]
    cancel = threading.Event()
    cancel.set()
    assert _twin(spec, cancel=cancel) == _ref(spec, cancel=cancel) == {
        "state": "cancelled", "step": 0, "history": []}


def test_train_job_crash_and_resume_match_the_reference(monkeypatch):
    """A crash at step 6 with a checkpoint every 4 steps, then a resubmission
    with the same workdir: both modules resume at step 4, and the resumed
    losses agree."""
    _carry_params(monkeypatch)
    spec = dict(TRAIN, steps=10, checkpoint_every=4, workdir="ckpts:runs/crash")
    out = {}
    for name, run, store in (("ref", _ref, JObjectStore()), ("twin", _twin, ObjectStore())):
        with pytest.raises(RuntimeError, match="injected crash at step 6"):
            run(dict(spec, crash_at_step=6), store=store)
        out[name] = run(spec, store=store)
        steps = sorted(k.split("/")[2] for k in store.list("ckpts", "runs/crash/")
                       if k.endswith("MANIFEST.json"))
        assert steps == ["step_00000004", "step_00000008", "step_00000010"], steps
    assert out["twin"]["start_step"] == out["ref"]["start_step"] == 4
    assert len(out["twin"]["history"]) == 6
    assert _rel(out["twin"]["history"], out["ref"]["history"]) <= TOL


def test_train_payload_writes_train_out_and_the_history():
    """The payload's outputs, as the reference's: ``train.out`` without the
    history, the loss curve uploaded under the workdir."""
    outs = {}
    for name, mod, store in (("ref", JJX, JObjectStore()), ("twin", TJX, ObjectStore())):
        kw = {} if mod is JJX else {"device": "cpu"}
        cluster = mod.make_jaxlocal_cluster(store, **kw)
        try:
            job = cluster.submit(json.dumps(dict(TRAIN, steps=2, workdir="runs:t")),
                                 {"OutputFileName": "train.out"}, {})
            _wait(lambda: cluster.get(job.id).state in ("COMPLETED", "FAILED"))
            assert job.state == "COMPLETED", job.reason
            hist = json.loads(store.get("runs", f"t/history_{job.id}.json"))
            outs[name] = (sorted(json.loads(job.outputs["train.out"])), len(hist), job.id)
        finally:
            cluster.shutdown()
    assert outs["twin"] == outs["ref"]
    assert outs["twin"][0] == ["final_loss", "start_step", "state", "step"]


# -- the serve job ----------------------------------------------------------------------


def _wait(pred, timeout=60.0, what="the condition"):
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise TimeoutError(f"{what} not met in {timeout} s")
        time.sleep(0.01)


def _serve_tokens(cluster, prompts, new=5):
    job = cluster.submit(json.dumps(SERVE), {}, {})
    _wait(lambda: cluster.serve_health(job.id)[0] == 200)
    got = [None] * len(prompts)

    def ask(i):
        got[i] = cluster.serve_invoke(job.id, {"prompt": prompts[i], "max_new_tokens": new})

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert cluster.cancel_if_live(job.id) == "cancelled"
    _wait(lambda: job.state == "CANCELLED")
    assert job.handler is None
    return job, got


def test_serve_job_gives_the_reference_replicas_tokens(monkeypatch):
    """gemma-smoke at ``max_batch=2``: four prompts from four threads, so the
    two slots fill and refill; each request's greedy tokens are the
    reference replica's."""
    _carry_params(monkeypatch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).tolist() for n in (8, 3, 6, 1)]
    out = {}
    for name, mod, store in (("ref", JJX, JObjectStore()), ("twin", TJX, ObjectStore())):
        kw = {} if mod is JJX else {"device": "cpu"}
        cluster = mod.make_jaxlocal_cluster(store, **kw)
        try:
            job, got = _serve_tokens(cluster, prompts)
        finally:
            cluster.shutdown()
        assert [status for status, _ in got] == [200] * 4, got
        assert {body["served_by"] for _, body in got} == {job.id}
        assert job.invocations == 4
        out[name] = [body["tokens"] for _, body in got]
    assert out["twin"] == out["ref"]
    assert [len(t) for t in out["twin"]] == [5] * 4


def test_serve_job_fails_its_parked_requests_when_the_engine_raises(monkeypatch):
    """A tick that raises (a kernel failing on the card) fails the job with
    its reason and every parked request with it (HTTP 500), never a request
    that waits on."""
    from repro_torch.serving import engine as TE

    def broken(self):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(TE.ServingEngine, "step", broken)
    cluster = TJX.make_jaxlocal_cluster(ObjectStore(), device="cpu")
    try:
        job = cluster.submit(json.dumps(SERVE), {}, {})
        _wait(lambda: cluster.serve_health(job.id)[0] == 200)
        status, body = cluster.serve_invoke(job.id, {"prompt": [1, 2, 3]})
        _wait(lambda: job.state == "FAILED")
    finally:
        cluster.shutdown()
    assert status == 500 and "kernel launch failed" in body["error"], body
    assert job.reason == "RuntimeError: kernel launch failed"


# -- the REST dialect ----------------------------------------------------------------------


def _transcript(mod, **kw):
    """The same calls through ``make_server``'s ``handle``, as the Bridge's
    adapter sends them: (call, status, the body's keys) for each, with the
    keys of a job record where the body carries one."""
    cluster = mod.make_jaxlocal_cluster(ObjectStore() if mod is TJX else JObjectStore(), **kw)
    srv = mod.make_server(cluster, token=TOKEN)
    out = {}

    def call(name, method, path, body=None, headers=AUTH):
        r = srv.handle(method, path, body, headers, timeout=5.0)
        keys = sorted(r.json) if isinstance(r.json, dict) else r.json
        recs = (r.json or {}).get("jobs") or (r.json or {}).get("events") or []
        out[name] = (r.status, keys, [sorted(x) for x in recs])
        return r

    def done(jid):
        return cluster.get(str(jid)).state in ("COMPLETED", "FAILED", "CANCELLED")

    try:
        call("ping", "GET", f"{SLURM}/ping")
        call("partitions", "GET", f"{SLURM}/partitions")
        call("bad token", "GET", f"{SLURM}/ping", headers={"Authorization": "Bearer nope"})
        call("no token", "GET", f"{SLURM}/partitions", headers={})
        call("submit without a script", "POST", f"{SLURM}/job/submit", {"job": {}})
        train = json.dumps(dict(TRAIN, steps=1, batch=1, seq=8))
        jid = call("submit", "POST", f"{SLURM}/job/submit",
                   {"script": train, "job": {"OutputFileName": "train.out"},
                    "params": {}}).json["job_id"]
        arr = call("array submit", "POST", f"{SLURM}/job/submit",
                   {"script": train, "job": {}, "array_size": 2, "array_start": 4,
                    "params_by_index": [{"X": "a"}, {"X": "b"}]}).json["task_ids"]
        _wait(lambda: all(done(j) for j in [jid] + arr))
        assert [cluster.get(str(j)).params["SLURM_ARRAY_TASK_ID"] for j in arr] == ["4", "5"]
        call("job", "GET", f"{SLURM}/job/{jid}")
        call("unknown job", "GET", f"{SLURM}/job/99999")
        call("jobs by ids", "GET", f"{SLURM}/jobs?ids={jid},{arr[0]},99999")
        call("jobs without ids", "GET", f"{SLURM}/jobs")
        version = call("events since -1", "GET", f"{SLURM}/jobs/events?since=-1").json["version"]
        call("events by ids", "GET", f"{SLURM}/jobs/events?since=0&ids={jid}")
        call("events, none new", "GET", f"{SLURM}/jobs/events?since={version}&wait=0.05")
        sid = call("submit a serve job", "POST", f"{SLURM}/job/submit",
                   {"script": json.dumps(SERVE), "job": {}}).json["job_id"]
        _wait(lambda: cluster.serve_health(str(sid))[0] == 200)
        call("health", "GET", f"{SLURM}/job/{sid}/health")
        call("health of a finished job", "GET", f"{SLURM}/job/{jid}/health")
        call("health of an unknown job", "GET", f"{SLURM}/job/99999/health")
        call("invoke", "POST", f"{SLURM}/job/{sid}/invoke", {"prompt": [1, 2, 3],
                                                            "max_new_tokens": 2})
        call("invoke a finished job", "POST", f"{SLURM}/job/{jid}/invoke", {"prompt": [1]})
        call("delete a live job", "DELETE", f"{SLURM}/job/{sid}")
        _wait(lambda: done(sid))
        call("delete a finished job", "DELETE", f"{SLURM}/job/{jid}")
        call("delete an unknown job", "DELETE", f"{SLURM}/job/99999")
        call("no such route", "PUT", f"{SLURM}/job/{jid}")
        out["counters"] = (srv.request_count, sorted(srv.stats))
    finally:
        cluster.shutdown()
    return out


CALLS = ["ping", "partitions", "bad token", "no token", "submit without a script", "submit",
         "array submit", "job", "unknown job", "jobs by ids", "jobs without ids",
         "events since -1", "events by ids", "events, none new", "submit a serve job",
         "health", "health of a finished job", "health of an unknown job", "invoke",
         "invoke a finished job", "delete a live job", "delete a finished job",
         "delete an unknown job", "no such route", "counters"]


@pytest.fixture(scope="module")
def transcripts():
    return {"ref": _transcript(JJX), "twin": _transcript(TJX, device="cpu")}


@pytest.mark.parametrize("name", CALLS)
def test_every_route_answers_as_the_reference(transcripts, name):
    assert transcripts["twin"][name] == transcripts["ref"][name]


def test_the_dialect_transcript_covers_every_route(transcripts):
    assert sorted(transcripts["twin"]) == sorted(CALLS)
    statuses = {transcripts["twin"][c][0] for c in CALLS if c != "counters"}
    assert statuses == {200, 204, 400, 401, 404, 409, 503}
    routes = [r for r in transcripts["twin"]["counters"][1] if not r.startswith("(")]
    assert len(routes) == 9, routes  # every route of the dialect was called


# -- without a card ---------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["make_jaxlocal_cluster", "jax_train_payload", "train_job"])
def test_no_quiet_cpu_run_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = getattr(TJX, entry)
    args = (dict(TRAIN, steps=1), ObjectStore()) if entry == "train_job" else (ObjectStore(),)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)
    made = fn(*args, device="cpu")  # runs when the caller asks for the CPU
    if entry == "make_jaxlocal_cluster":
        made.shutdown()


def test_serve_job_raises_without_a_card(monkeypatch):
    from repro_torch.core.backends import base as TB

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = TB.ClusterJob(id="1", script=json.dumps(SERVE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TJX.serve_job(SERVE, job, None)
    assert job.handler is None


# -- the unmodified Bridge driving the twin ------------------------------------------------


class _Wire:
    """The network between the Bridge and a twin's server: the reference's
    ``FaultProfile`` decides whether a request is lost before it arrives
    and whether its reply is lost after the server ran it."""

    def __init__(self, server, fault: FaultProfile):
        self.server, self.fault = server, fault

    def handle(self, method, path, json_body=None, headers=None, timeout=None):
        self.fault.check()
        resp = self.server.handle(method, path, json_body, headers, timeout=timeout)
        if self.fault.reply_lost():
            raise TransportError("simulated partition: reply lost")
        return resp


def _twin_env(slots=4, fault=None, **kw):
    """A BridgeEnvironment whose jaxlocal resource manager is the twin on the
    CPU; returns (env, the twin's object store).  Not started."""
    env = BridgeEnvironment(slots=slots, **kw)
    env.clusters["jaxlocal"].shutdown()
    store = ObjectStore()
    cluster = TJX.make_jaxlocal_cluster(store, slots=max(slots, 2), device="cpu")
    env.clusters["jaxlocal"] = cluster  # env.stop() shuts it down
    srv = TJX.make_server(cluster, token=TOKENS["jaxlocal"])
    env.servers["jaxlocal"] = srv
    env.directory.register(URLS["jaxlocal"], srv if fault is None else _Wire(srv, fault))
    return env, store


def _train_spec(env, *, steps=30, ckpt=10, workdir="ckpts:runs/t1", crash_at=0,
                seq=16, batch=2, lr=1e-2):
    """``tests/test_e2e_training.py::_train_spec``."""
    script = json.dumps({
        "arch": "gemma-2b", "steps": steps, "batch": batch, "seq": seq,
        "checkpoint_every": ckpt, "workdir": workdir, "lr": lr,
        "crash_at_step": crash_at,
    })
    return env.make_spec("jaxlocal", script=script, updateinterval=0.05,
                         jobproperties={"OutputFileName": "train.out"})


def test_bridged_twin_training_completes_and_learns():
    env, store = _twin_env(default_duration=0.05)
    with env:
        env.submit("train1", _train_spec(env, steps=80, batch=4, workdir="ckpts:runs/learn"))
        job = env.operator.wait_for("train1", timeout=300)
    assert job.status.state == DONE, job.status.message
    hist_keys = [k for k in store.list("ckpts", "runs/learn/") if "history" in k]
    assert hist_keys == [f"runs/learn/history_{job.status.job_id}.json"]
    hist = json.loads(store.get("ckpts", hist_keys[0]))
    assert len(hist) == 80
    assert hist[-1] < hist[0] * 0.7, (hist[0], hist[-1])
    assert np.isfinite(hist).all()


def test_bridged_twin_resumes_from_a_checkpoint_after_a_crash():
    """Crash at step 15 (a checkpoint every 10): the CR fails with the job's
    reason; a new CR with the same workdir resumes from step 10."""
    env, _ = _twin_env(default_duration=0.05)
    wd = "ckpts:runs/crash"
    with env:
        env.submit("crashy", _train_spec(env, steps=25, ckpt=10, workdir=wd, crash_at=15))
        job = env.operator.wait_for("crashy", timeout=120)
        assert job.status.state == FAILED
        assert "injected crash" in job.status.message
        env.submit("crashy2", _train_spec(env, steps=25, ckpt=10, workdir=wd))
        job2 = env.operator.wait_for("crashy2", timeout=120)
        assert job2.status.state == DONE
        jid = env.statestore.get(env.operator.cm_name(job2)).get("id")
        result = json.loads(env.clusters["jaxlocal"].jobs[jid].outputs["train.out"])
    assert result["start_step"] == 10, result
    assert result["state"] == "done" and result["step"] == 25


def test_bridged_twin_job_survives_network_faults():
    """Once the job runs: three lost requests in a row (one status poll's
    in-call retries all fail) and a 0.4 s blackout.  The Bridge rides them
    out through its own ``TransportError`` handling and the job reaches
    DONE, submitted once."""
    fault = FaultProfile(seed=3)
    env, _ = _twin_env(default_duration=0.05, fault=fault)
    with env:
        env.submit("flaky", _train_spec(env, steps=200, ckpt=0, workdir=""))
        _wait(lambda: env.registry.get("flaky").status.state == RUNNING)
        fault.fail_next(3)
        fault.schedule_blackout(start_in=0.0, duration=0.4)
        job = env.operator.wait_for("flaky", timeout=120)
        channel = env.directory.channels()[URLS["jaxlocal"]]
    assert job.status.state == DONE, job.status.message
    assert channel.errors >= 3 and channel.retries >= 2, (channel.errors, channel.retries)
    assert len(env.clusters["jaxlocal"].jobs) == 1


def test_bridged_twin_serving_heals_after_a_replica_kill():
    """``examples/model_serving.py`` with the twin on both managers: two
    replicas spread over them, traffic from 4 threads, one replica killed
    mid-traffic; no request is lost and ready replicas return to 2."""
    new = 4
    env, _ = _twin_env(slots=8)
    url2 = "https://jax.pod1.example.com"
    cluster2 = TJX.make_jaxlocal_cluster(ObjectStore(), name="jaxlocal2", slots=8,
                                         start_numbering=8000, device="cpu")
    env.clusters["jaxlocal2"] = cluster2
    srv2 = TJX.make_server(cluster2, token=TOKENS["jaxlocal"])
    env.servers["jaxlocal2"] = srv2
    env.directory.register(url2, srv2)
    script = json.dumps({"mode": "serve", "arch": "gemma-2b", "max_batch": 4, "max_len": 48,
                         "prefill_len": 8, "seed": 0})
    with env:
        spec = env.make_service_spec(
            "jaxlocal", replicas=2, script=script, updateinterval=0.05,
            health=HealthProbeSpec(failure_threshold=5, startup_failure_threshold=2000),
            placement=PlacementSpec(candidates=[
                PlacementCandidate(URLS["jaxlocal"], IMAGES["jaxlocal"], "jaxlocal-secret"),
                PlacementCandidate(url2, IMAGES["jaxlocal"], "jaxlocal-secret"),
            ], strategy="spread"))
        handle = env.bridge.submit_service("llm", spec)
        handle.wait_ready(timeout=120)
        assert {e["resourceURL"] for e in handle.endpoints()} == {URLS["jaxlocal"], url2}

        router = handle.router(request_timeout=90)
        stop = threading.Event()
        completed, failures = [], []

        def traffic(tid):
            i = 0
            while not stop.is_set():
                try:
                    out = router.request({"prompt": [1 + tid, 2, 3, i % 50],
                                          "max_new_tokens": new})
                    if len(out["tokens"]) != new:
                        failures.append((tid, i, out))
                    completed.append(out["served_by"])
                except Exception as exc:  # a lost request is the failure under test
                    failures.append((tid, i, repr(exc)))
                i += 1

        first = {e["job_id"] for e in handle.endpoints()}
        threads = [threading.Thread(target=traffic, args=(t,), daemon=True) for t in range(4)]
        for t in threads:
            t.start()
        try:
            _wait(lambda: first <= set(completed), 120, "traffic to both replicas")
            victim = handle.endpoints()[0]
            vcluster = (env.clusters["jaxlocal"] if victim["resourceURL"] == URLS["jaxlocal"]
                        else cluster2)
            assert vcluster.cancel_if_live(victim["job_id"]) == "cancelled"
            _wait(lambda: (victim["job_id"] not in [e["job_id"] for e in handle.endpoints()]
                           and handle.ready_replicas() == 2), 120, "recovery to 2 replicas")
            (replacement,) = {e["job_id"] for e in handle.endpoints()} - first
            _wait(lambda: replacement in completed, 120, "a request served by the replacement")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        handle.cancel()
        handle.wait(timeout=60)
    assert not failures, failures[:3]
    assert vcluster.jobs[victim["job_id"]].state == "CANCELLED"

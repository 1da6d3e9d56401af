"""The port's fleet router (`serve/fleet.py`) on the CPU against canned
JSON stub replicas (a copy of the stub tests/test_fleet.py builds):
routing, retries and the retry budget, the 429 / 504 shed-don't-retry
contract, health, drain and re-admit, the shared result cache with the
neighbours key's `index_digest`, exactly-once sealing, the HTTP front;
then the fingerprint sweep over real port replicas' `/healthz`, and
`FleetCollector`'s merge of router and replica event streams."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.models.proteinbert import init
from proteinbert_tpu_torch.obs import Telemetry, read_events
from proteinbert_tpu_torch.serve.fleet import (
    FleetCollector, FleetRouter, make_fleet_http_server,
)
from proteinbert_tpu_torch.serve.http import make_http_server
from proteinbert_tpu_torch.serve.server import Server

torch.set_num_threads(1)


class StubReplica:
    """Canned-JSON serve replica: scriptable per-path status/payload,
    request counting, torn-health mode, and a hard kill (socket gone)."""

    def __init__(self, name):
        self.name = name
        self.requests = []
        self.responses = {}  # path -> (status, payload dict)
        self.health = {"ok": True, "stats": {}}
        self.torn_health = False
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, status, body: bytes):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    if stub.torn_health:
                        # A replica dying mid-write: half a JSON object.
                        self._send(200, b'{"ok": tru')
                    else:
                        self._send(200, json.dumps(stub.health).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                with stub.lock:
                    stub.requests.append((self.path, body))
                status, payload = stub.responses.get(
                    self.path, (200, {"from": stub.name}))
                self._send(status, json.dumps(payload).encode())

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.alive = True

    def request_count(self):
        with self.lock:
            return len(self.requests)

    def kill(self):
        if self.alive:
            self.alive = False
            self.httpd.shutdown()
            self.httpd.server_close()


@pytest.fixture()
def stubs():
    reps = [StubReplica(f"s{i}") for i in range(3)]
    yield reps
    for r in reps:
        r.kill()


def _router(stubs, **kw):
    kw.setdefault("health_interval_s", 0)  # tests drive health_tick()
    kw.setdefault("sleep", lambda s: None)  # no real backoff waits
    kw.setdefault("cache_size", 0)
    return FleetRouter([(r.name, r.url) for r in stubs], **kw).start()


def _body(seq="MKTAYIAK", **extra):
    return json.dumps({"seq": seq, **extra}).encode()


# ------------------------------------------------------------ routing

def test_ok_routes_and_seals_once(stubs):
    r = _router(stubs)
    status, body, headers = r.route("/v1/embed", _body())
    assert status == 200
    assert headers["X-PBT-Fleet-Replica"] == json.loads(body)["from"]
    st = r.stats()
    assert st["accepted"] == st["sealed"] == 1
    assert st["outcomes"] == {"ok": 1}
    r.drain()


def test_least_inflight_spreads_load(stubs):
    r = _router(stubs)
    for i in range(9):
        r.route("/v1/embed", _body(f"SEQ{i}" * 3))
    counts = [s.request_count() for s in stubs]
    assert sum(counts) == 9 and all(c >= 1 for c in counts)
    r.drain()


def test_retry_on_dead_replicas_then_ok(stubs):
    stubs[0].kill()
    stubs[1].kill()
    r = _router(stubs, max_retries=3)
    status, body, _ = r.route("/v1/embed", _body())
    assert status == 200 and json.loads(body)["from"] == "s2"
    st = r.stats()
    assert st["outcomes"] == {"retried_ok": 1} and st["retries_spent"] >= 1
    r.drain()


def test_replica_503_is_retried(stubs):
    for s in stubs[:2]:
        s.responses["/v1/embed"] = (503, {"type": "closed"})
    r = _router(stubs, max_retries=3)
    status, body, _ = r.route("/v1/embed", _body())
    assert status == 200 and json.loads(body)["from"] == "s2"
    r.drain()


@pytest.mark.parametrize("status_code,kind", [(429, "queue_full"),
                                              (504, "deadline")])
def test_backpressure_sheds_without_retry(stubs, status_code, kind):
    for s in stubs:
        s.responses["/v1/embed"] = (status_code, {"type": kind})
    r = _router(stubs, max_retries=3)
    status, body, _ = r.route("/v1/embed", _body())
    assert status == status_code and json.loads(body)["type"] == kind
    # Exactly one replica was asked: backpressure is never amplified.
    assert sum(s.request_count() for s in stubs) == 1
    assert r.stats()["outcomes"] == {"shed": 1}
    assert r.stats()["retries_spent"] == 0
    r.drain()


def test_client_error_passes_through_as_failed(stubs):
    for s in stubs:
        s.responses["/v1/predict_task"] = (404, {"type": "unknown_head"})
    r = _router(stubs)
    status, _, _ = r.route("/v1/predict_task",
                           _body("MKT", head_id="nope"))
    assert status == 404 and r.stats()["outcomes"] == {"failed": 1}
    assert sum(s.request_count() for s in stubs) == 1
    r.drain()


def test_all_dead_returns_typed_502(stubs):
    for s in stubs:
        s.kill()
    r = _router(stubs, max_retries=2)
    status, body, _ = r.route("/v1/embed", _body())
    assert status == 502
    assert json.loads(body)["type"] == "replica_unavailable"
    assert r.stats()["outcomes"] == {"failed": 1}
    r.drain()


def test_retry_budget_caps_a_retry_storm(stubs):
    for s in stubs:
        s.kill()
    r = _router(stubs, max_retries=10, retry_budget_floor=3,
                retry_budget_ratio=0.0)
    statuses = [r.route("/v1/embed", _body(f"S{i}" * 4))[0]
                for i in range(4)]
    assert all(s in (502, 503) for s in statuses), statuses
    st = r.stats()
    assert st["retries_spent"] == 3 and st["sealed"] == 4
    assert set(st["outcomes"]) <= {"failed", "shed"}
    r.drain()


# ------------------------------------------------- health and lifecycle

def test_torn_health_kills_then_readmits(stubs, tmp_path):
    tele = Telemetry(events_path=str(tmp_path / "ev.jsonl"))
    r = _router(stubs, telemetry=tele, fail_threshold=2,
                readmit_threshold=2)
    stubs[0].torn_health = True
    for _ in range(2):
        r.health_tick()
    assert r.replica_status()[0]["state"] == "dead"
    for i in range(6):
        r.route("/v1/embed", _body(f"Q{i}" * 3))
    assert stubs[0].request_count() == 0
    stubs[0].torn_health = False
    for _ in range(2):
        r.health_tick()
    assert r.replica_status()[0]["state"] == "up"
    r.drain()
    tele.close()
    states = [x["state"] for x in read_events(str(tmp_path / "ev.jsonl"),
                                               strict=True)
              if x["event"] == "fleet_replica" and x["replica"] == "s0"]
    assert states == ["dead", "admitted"]


def test_slo_burn_degrades_and_is_the_last_resort(stubs):
    stubs[0].health = {"ok": True, "stats": {"slo": {
        "latency_e2e": {"burn_rate": 2.5}}}}
    r = _router(stubs, degrade_burn=1.0)
    r.health_tick()
    assert r.replica_status()[0]["state"] == "degraded"
    for i in range(6):
        r.route("/v1/embed", _body(f"W{i}" * 3))
    assert stubs[0].request_count() == 0
    stubs[1].kill()
    stubs[2].kill()
    status, body, _ = r.route("/v1/embed", _body("LASTRESORT"))
    assert status == 200 and json.loads(body)["from"] == "s0"
    r.drain()


def test_drain_admit_round_trip_and_no_capacity_shed(stubs):
    r = _router(stubs)
    for s in ("s0", "s1", "s2"):
        r.drain_replica(s)
    status, body, _ = r.route("/v1/embed", _body())
    assert status == 503 and json.loads(body)["type"] == "no_capacity"
    r.admit_replica("s1")
    status, body, _ = r.route("/v1/embed", _body("AGAIN"))
    assert status == 200 and json.loads(body)["from"] == "s1"
    with pytest.raises(KeyError):
        r.drain_replica("nope")
    r.drain()


# ---------------------------------------------------------- the cache

def test_shared_cache_survives_failover(stubs):
    r = _router(stubs, cache_size=16)
    status, first, _ = r.route("/v1/embed", _body("CACHEDSEQ"))
    assert status == 200
    for s in stubs:
        s.kill()
    status, again, headers = r.route("/v1/embed", _body("CACHEDSEQ"))
    assert status == 200 and again == first
    assert headers.get("X-PBT-Fleet-Cache") == "hit"
    assert r.stats()["outcomes"]["cache_hit"] == 1
    r.drain()


def test_cache_key_scopes_kind_head_and_top_k(stubs):
    r = _router(stubs, cache_size=16)
    r.route("/v1/embed", _body("SCOPESEQ"))
    r.route("/v1/predict_go", _body("SCOPESEQ", top_k=3))
    r.route("/v1/predict_go", _body("SCOPESEQ", top_k=5))
    assert r.stats()["cache"]["hits"] == 0
    assert sum(s.request_count() for s in stubs) == 3
    r.drain()


@pytest.mark.parametrize("digest", [None, "ab" * 32])
def test_neighbors_cache_key_carries_the_index_digest(stubs, digest):
    """Without the fleet's index digest a neighbours answer is never
    cached; with it, a repeat hits, and another k misses."""
    r = _router(stubs, cache_size=16, index_digest=digest)
    for k in (5, 5, 7):
        r.route("/v1/neighbors", _body("NBRSEQ", k=k))
    hits = r.stats()["cache"]["hits"]
    assert hits == (0 if digest is None else 1)
    assert sum(s.request_count() for s in stubs) == 3 - hits
    key = r._cache_key("neighbors", {"seq": "NBRSEQ", "k": 5})
    assert (key is None) == (digest is None)
    r.drain()


# ----------------------------------------------------------- HTTP front

def test_http_front_routes_and_controls(stubs, tmp_path):
    tele = Telemetry(events_path=str(tmp_path / "ev.jsonl"))
    r = _router(stubs, telemetry=tele)
    httpd = make_fleet_http_server(r, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(path, payload):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp, json.loads(resp.read())

    try:
        resp, _ = post("/v1/embed", {"seq": "MKTAYIAK"})
        assert resp.status == 200 and resp.headers["X-PBT-Fleet-Request-Id"]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and len(health["replicas"]) == 3
        _, out = post("/fleet/drain", {"replica": "s0"})
        assert [x for x in out["replicas"]
                if x["name"] == "s0"][0]["state"] == "draining"
        assert post("/fleet/admit", {"replica": "s0"})[1]["ok"]
        with urllib.request.urlopen(base + "/rollout/status",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["rollout"] is None
    finally:
        httpd.shutdown()
        httpd.server_close()
        r.drain()
        tele.close()
    events = [x["event"] for x in read_events(str(tmp_path / "ev.jsonl"),
                                              strict=True)]
    assert events[0] == "fleet_start" and events[-1] == "fleet_end"
    assert events.count("fleet_request") == 1


# ------------------------------------------- port replicas, collector

@pytest.fixture(scope="module")
def replicas(tmp_path_factory):
    """Two port servers (the `tiny` preset, seeded weights of their own,
    the second of another trunk) behind serve/http.py, each with its
    event stream."""
    cfg = get_preset("tiny")
    root = tmp_path_factory.mktemp("replicas")
    out = []
    for i, seed in enumerate((1, 1, 2)):
        tele = Telemetry(events_path=str(root / f"r{i}.jsonl"))
        srv = Server(init(cfg.model, torch.Generator().manual_seed(seed),
                          device="cpu"), cfg, device="cpu",
                     buckets=(32, 64, 128), warm_kinds=(), telemetry=tele,
                     replica_id=f"r{i}").start()
        httpd = make_http_server(srv, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out.append({"srv": srv, "httpd": httpd, "tele": tele,
                    "events": str(root / f"r{i}.jsonl"),
                    "url": f"http://127.0.0.1:{httpd.server_address[1]}"})
    yield out
    for r in out:
        r["httpd"].shutdown()
        r["httpd"].server_close()
        r["srv"].close(drain=True, timeout=60)
        r["tele"].close()


def test_fingerprint_sweep_over_port_healthz(replicas, tmp_path):
    """The sweep reads each port replica's resident fingerprint from its
    /healthz: two replicas of one trunk are coherent, a third of another
    trunk makes the fleet degraded, and a dead one does not count."""
    tele = Telemetry(events_path=str(tmp_path / "router.jsonl"))
    router = FleetRouter([(f"r{i}", r["url"]) for i, r in
                          enumerate(replicas)], telemetry=tele,
                         health_interval_s=0).start()
    router.drain_replica("r2")
    router.health_tick()
    st = router.fingerprint_status()
    fps = [r["srv"].trunk_fp() for r in replicas]
    assert st["fleet_state"] == "coherent"
    assert st["fingerprints"] == {"r0": fps[0], "r1": fps[1],
                                  "r2": fps[2]}
    assert fps[0] == fps[1] != fps[2]
    router.admit_replica("r2")
    router.health_tick()
    assert router.fingerprint_status()["fleet_state"] == "degraded"
    with router._lock:
        router._transition(router.replicas[2], "dead", reason="test")
    router._sweep_fingerprints()
    assert router.fingerprint_status()["fleet_state"] == "coherent"
    router.drain()
    tele.close()
    fleet = [r["state"] for r in read_events(str(tmp_path / "router.jsonl"),
                                             strict=True)
             if r["event"] == "rollout_fleet"]
    assert fleet == ["degraded", "coherent"]


def _settled(srv, timeout_s: float = 30.0) -> None:
    """Wait until a live replica has sealed every request it answered:
    its completer answers a batch's requests first, then seals each (the
    serve_request event) and counts the batch's rows, so a stream read
    right after the last answer can miss the last seals."""
    deadline = time.monotonic() + timeout_s
    while True:
        st = srv.stats()
        if st["batched_rows"] == st["completed"]:
            return
        assert time.monotonic() < deadline, st
        time.sleep(0.002)


def test_collector_merges_router_and_replica_streams(replicas, tmp_path):
    """Requests routed to port replicas carry the fleet id into each
    replica's serve_request; the merged stream is re-sequenced, keeps
    every record, and seals each request exactly once."""
    path = str(tmp_path / "router.jsonl")
    tele = Telemetry(events_path=path)
    router = FleetRouter([(f"r{i}", r["url"]) for i, r in
                          enumerate(replicas[:2])], telemetry=tele,
                         health_interval_s=0, cache_size=0).start()
    ids = []
    for i in range(6):
        status, _, headers = router.route(
            "/v1/embed", _body("MKTAYIAKQ" * (i + 1)))
        assert status == 200
        ids.append(headers["X-PBT-Fleet-Request-Id"])
    router.drain()
    tele.close()
    for r in replicas[:2]:
        _settled(r["srv"])
    sources = {"router": path, **{f"r{i}": r["events"]
                                  for i, r in enumerate(replicas[:2])}}
    collector = FleetCollector(sources)
    merged = collector.collect()
    assert [r["seq"] for r in merged] == list(range(len(merged)))
    assert len(merged) == sum(len(read_events(p)) for p in sources.values())
    assert collector.seal_violations(merged) == {}
    served = {r["trace_id"] for r in merged
              if r["event"] == "serve_request" and r.get("trace_id")}
    assert set(ids) <= served
    out = str(tmp_path / "fleet.jsonl")
    assert collector.write(out) == len(merged)
    assert len(read_events(out, strict=True)) == len(merged)

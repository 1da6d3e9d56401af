"""The port's JSON/HTTP shim (`serve/http.py`) on the CPU, beside the JAX
package's on the same weights (carried through the flat export layout):
each route's answer over 127.0.0.1 equals the JAX server's within
rtol = atol = 1e-5 (float32 trunks, the same arithmetic in another
summation order: the JAX-against-port tolerance of test_torch_ragged.py;
the two differ by up to ~1.4e-6 here) and the port's own in-process
answer within test_torch_serve.py's 1e-6, with the same status codes for
a bad body, an unknown route and a closed server; the routes of modules
the port does not have yet answer 404 "no such route", the task-head
routes the typed 404 for an unknown head; traced responses carry
X-PBT-Request-Id and join a caller's X-PBT-Trace; /healthz, /stats,
/metrics and /metrics.json answer."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from proteinbert_tpu.configs import get_preset as jax_preset
from proteinbert_tpu.export import flatten_params
from proteinbert_tpu.models import proteinbert as jmodel
from proteinbert_tpu.obs import Telemetry as JTelemetry
from proteinbert_tpu.serve.http import make_http_server as jax_http
from proteinbert_tpu.serve.server import Server as JServer
from proteinbert_tpu_torch.configs import get_preset
from proteinbert_tpu_torch.obs import Telemetry
from proteinbert_tpu_torch.serve.http import make_http_server
from proteinbert_tpu_torch.serve.server import Server
from proteinbert_tpu_torch.weights import params_from_flat

BUCKETS = (32, 64, 128)
RTOL = ATOL = 1e-5     # against the JAX server
SELF_TOL = 1e-6        # against the port's own in-process answer


def _post(url, payload, headers=None):
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json",
                                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class _Endpoint:
    def __init__(self, srv, make):
        self.srv = srv
        srv.start()
        self.httpd = make(srv, port=0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)
        self.srv.close(drain=True, timeout=60)


@pytest.fixture(scope="module")
def endpoints(tmp_path_factory):
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(6), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    kw = dict(buckets=BUCKETS, max_batch=4, max_wait_s=0.002, cache_size=0,
              warm_kinds=())
    eps = {"jax": _Endpoint(JServer(jparams, jcfg, telemetry=JTelemetry(),
                                    **kw), jax_http),
           "port": _Endpoint(Server(tparams, tcfg, device="cpu",
                                    telemetry=Telemetry(),
                                    registry=str(tmp_path_factory.mktemp(
                                        "heads")), **kw),
                             make_http_server)}
    yield eps
    for ep in eps.values():
        ep.close()


SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY" * 3, "GG"]


@pytest.mark.parametrize("seq", SEQS)
def test_embed_matches_the_jax_server(endpoints, seq):
    got = {k: _post(ep.base + "/v1/embed", {"seq": seq})
           for k, ep in endpoints.items()}
    for status, _, _ in got.values():
        assert status == 200
    for key in ("global", "local_mean"):
        np.testing.assert_allclose(got["port"][1][key], got["jax"][1][key],
                                   rtol=RTOL, atol=ATOL)
    local = endpoints["port"].srv.embed(seq, timeout=60)
    np.testing.assert_allclose(got["port"][1]["global"], local["global"],
                               rtol=SELF_TOL, atol=SELF_TOL)


@pytest.mark.parametrize("top_k", [None, 3])
def test_predict_go_matches_the_jax_server(endpoints, top_k):
    payload = {"seq": SEQS[1]}
    if top_k is not None:
        payload["top_k"] = top_k
    got = {k: _post(ep.base + "/v1/predict_go", payload)[:2]
           for k, ep in endpoints.items()}
    assert got["port"][0] == got["jax"][0] == 200
    if top_k is None:
        np.testing.assert_allclose(got["port"][1]["probs"],
                                   got["jax"][1]["probs"], rtol=RTOL,
                                   atol=ATOL)
    else:
        port, jx = got["port"][1]["top"], got["jax"][1]["top"]
        assert [i for i, _ in port] == [i for i, _ in jx]
        np.testing.assert_allclose([p for _, p in port], [p for _, p in jx],
                                   rtol=RTOL, atol=ATOL)


def test_predict_residues_fills_as_the_jax_server(endpoints):
    got = {k: _post(ep.base + "/v1/predict_residues",
                    {"seq": "MK?AYIA?QR"})[:2]
           for k, ep in endpoints.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 200 and "?" not in got["port"][1]["filled"]


@pytest.mark.parametrize("route,payload,status,kind", [
    ("/v1/embed", {"nope": 1}, 400, "bad_request"),
    ("/v1/embed", {"seq": 42}, 400, "bad_request"),
    ("/v1/predict_go", {"seq": "MKT", "top_k": "3"}, 400, "bad_request"),
    ("/v1/embed", {"seq": "MKT", "deadline_ms": True}, 400, "bad_request"),
    ("/v1/embed", b"{not json", 400, "bad_request"),
    ("/v1/predict_residues", {"seq": "A" * 200 + "?"}, 400, "too_long"),
    ("/v1/nope", {"seq": "MKT"}, 404, None),
])
def test_error_status_mapping_matches_the_jax_server(endpoints, route,
                                                     payload, status, kind):
    for name, ep in endpoints.items():
        got, body, _ = _post(ep.base + route, payload)
        assert got == status, (name, body)
        assert body.get("type") == kind, (name, body)


@pytest.mark.parametrize("route", [
    "/v1/predict_task", "/v1/neighbors", "/v1/heads/add",
    "/v1/heads/remove", "/v1/rollout/load", "/v1/rollout/flip"])
def test_routes_of_unported_modules_answer_404(endpoints, route):
    """The rollout routes are not served ("no such route"); the task-head
    routes are, and answer an unknown head with the typed 404 the JAX
    shim gives (the port's server has a registry without that head, so
    /v1/heads/add reaches it too); /v1/neighbors is served, and a server
    without an index answers it with the JAX shim's 400."""
    status, body, _ = _post(endpoints["port"].base + route,
                            {"seq": "MKT", "head_id": "h"})
    if route == "/v1/neighbors":
        assert status == 400 and body["type"] == "bad_request", body
        assert "no neighbor index" in body["error"]
    else:
        assert status == 404
    if route in ("/v1/predict_task", "/v1/heads/add", "/v1/heads/remove"):
        assert body["type"] == "unknown_head", body
    elif route != "/v1/neighbors":
        assert body["error"] == f"no such route {route}"
    status, body, _ = _get(endpoints["port"].base + "/v1/heads")
    assert status == 200 and json.loads(body) == {"heads": []}


def test_request_ids_and_trace_join(endpoints):
    ep = endpoints["port"]
    status, _, headers = _post(ep.base + "/v1/embed", {"seq": "MKTAYI"})
    assert status == 200 and headers.get("X-PBT-Request-Id")
    status, _, headers = _post(ep.base + "/v1/embed", {"seq": "MKTAYV"},
                               headers={"X-PBT-Trace": "fleet-7"})
    assert status == 200 and headers["X-PBT-Request-Id"] == "fleet-7"
    status, body, headers = _post(ep.base + "/v1/predict_residues",
                                  {"seq": "A" * 200 + "?"})
    assert status == 400 and headers.get("X-PBT-Request-Id")


def test_health_stats_and_metrics(endpoints):
    for name, ep in endpoints.items():
        for route in ("/healthz", "/stats"):
            status, body, _ = _get(ep.base + route)
            body = json.loads(body)
            assert status == 200 and body["ok"] is True
            assert body["mode"] == "bucketed" and body["quant"] == "fp32"
            assert {"cache", "latency", "pipeline", "queue_wait"} <= set(
                body["stats"]), name
        status, text, _ = _get(ep.base + "/metrics")
        assert status == 200 and b"serve_requests_total" in text, name
        status, body, _ = _get(ep.base + "/metrics.json")
        body = json.loads(body)
        assert status == 200 and set(body) == {"replica_id", "snapshot",
                                               "windows"}
        assert "serve_latency" in body["windows"]


def test_closed_server_answers_503_like_the_jax_server():
    """After drain() a POST is refused with 503 {"type": "closed"} by
    both shims (separate servers: the module's stay open)."""
    jcfg, tcfg = jax_preset("tiny"), get_preset("tiny")
    jparams = jmodel.init(jax.random.PRNGKey(6), jcfg.model)
    tparams = params_from_flat(flatten_params(jparams), tcfg.model,
                               device="cpu")
    for srv, make in ((JServer(jparams, jcfg, warm_kinds=()), jax_http),
                      (Server(tparams, tcfg, device="cpu", warm_kinds=()),
                       make_http_server)):
        ep = _Endpoint(srv, make)
        try:
            assert srv.drain(timeout=30)
            status, body, _ = _post(ep.base + "/v1/embed", {"seq": "MKT"})
            assert status == 503 and body["type"] == "closed"
        finally:
            ep.close()

"""Thin stdlib JSON/HTTP endpoint over the port's `Server` — a copy of
`proteinbert_tpu/serve/http.py` without the routes of what the port does
not have yet.

Deliberately `http.server`, not a framework: the endpoint's job is only
transport — every serving behavior (batching, backpressure, deadlines,
cache) lives in serve/server.py and is identical for in-process callers.

Routes (POST bodies and responses are JSON):

  POST /v1/embed             {"seq", "annotations"?, "deadline_ms"?}
       → {"global": [...], "local_mean": [...]}
  POST /v1/predict_go        {"seq", "top_k"?, "deadline_ms"?}
       → {"top": [[idx, prob], ...]} or {"probs": [...]}
  POST /v1/predict_residues  {"seq", "deadline_ms"?}
       → {"filled": "..."} (probs stay server-side: a (L, V) matrix
         per request is transfer weight, not serving signal)
  GET  /healthz, /stats      → {"ok": true, "mode": "bucketed"|"ragged",
                               "quant": "fp32"|"int8"|"int8_act",
                               "stats": {...}}
  GET  /metrics              → Prometheus textfile (the registry's
                               exposition; empty when telemetry is off)
  GET  /metrics.json         → {"replica_id", "snapshot", "windows"} —
                               the registry snapshot plus raw quantile-
                               window values

The JAX endpoint's task-head routes (`/v1/predict_task`, `/v1/heads*`),
`/v1/neighbors`, the blue-green `/v1/rollout/*` routes and the shadow
header answer 404 "no such route" here, like any unknown path, until the
modules behind them are ported; `/healthz` carries no trunk fingerprint
for the same reason.

Every response to an inference POST carries `X-PBT-Request-Id` when the
server traces (the id of its `serve_request` event); an `X-PBT-Trace`
header joins the request to a caller's trace id.

Typed-error → status mapping (the backpressure contract, visible to
clients): QueueFullError → 429, DeadlineExceededError → 504,
ServerClosedError → 503, SequenceTooLongError/ValueError/bad JSON → 400,
anything else on the future → 500. `ThreadingHTTPServer` gives one
thread per connection; they all funnel into the one scheduler through
Server.submit, so HTTP concurrency IS the micro-batching concurrency.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from proteinbert_tpu_torch.serve.errors import (
    DeadlineExceededError, QueueFullError, SequenceTooLongError,
    ServerClosedError,
)
from proteinbert_tpu_torch.serve.server import Server

_MAX_BODY = 32 * 1024 * 1024  # a seq + an 8943-float annotation vector fit


def _result_payload(kind: str, value, top_k: Optional[int]):
    if kind == "embed":
        return {"global": [float(x) for x in value["global"]],
                "local_mean": [float(x) for x in value["local_mean"]]}
    if kind == "predict_go":
        if top_k is not None:
            return {"top": [[i, p] for i, p in value]}
        return {"probs": [float(x) for x in value]}
    filled, _probs = value
    return {"filled": filled}


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet: telemetry covers it
            pass

        def _reply(self, status: int, payload,
                   request_id: Optional[str] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if request_id is not None:
                # The trace id (serve_request events, Perfetto lanes).
                self.send_header("X-PBT-Request-Id", request_id)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/stats"):
                self._reply(200, {"ok": True, "mode": server.serve_mode,
                                  "quant": server.quant,
                                  "stats": server.stats()})
            elif self.path == "/metrics":
                text = ""
                if getattr(server.tele, "metrics", None) is not None:
                    if server.slo:
                        # Prune-at-scrape: an idle stream's burn rate
                        # decays with its window instead of freezing.
                        server.slo.refresh_gauges()
                    text = server.tele.metrics.prometheus_text()
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/metrics.json":
                snapshot, windows = {}, {}
                metrics = getattr(server.tele, "metrics", None)
                if metrics is not None:
                    if server.slo:
                        server.slo.refresh_gauges()
                    snapshot = metrics.snapshot()
                    # Raw ring values: percentiles over several replicas
                    # are taken over the concatenated values.
                    windows = metrics.window_values()
                self._reply(200, {"replica_id": server.replica_id,
                                  "snapshot": snapshot,
                                  "windows": windows})
            else:
                self._reply(404, {"error": f"no such route {self.path}"})

        def _read_body(self):
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= _MAX_BODY:
                raise ValueError(f"bad Content-Length {length}")
            return json.loads(self.rfile.read(length))

        def do_POST(self):
            route = {"/v1/embed": "embed",
                     "/v1/predict_go": "predict_go",
                     "/v1/predict_residues": "predict_residues"}
            kind = route.get(self.path)
            if kind is None:
                self._reply(404, {"error": f"no such route {self.path}"})
                return
            request_id = None
            top_k = None
            try:
                body = self._read_body()
                seq = body["seq"]
                if not isinstance(seq, str):
                    raise ValueError("'seq' must be a string")
                deadline_ms = body.get("deadline_ms")
                if deadline_ms is not None and (
                        isinstance(deadline_ms, bool)
                        or not isinstance(deadline_ms, (int, float))):
                    raise ValueError("'deadline_ms' must be a number")
                top_k = body.get("top_k") if kind == "predict_go" else None
                if top_k is not None and (isinstance(top_k, bool)
                                          or not isinstance(top_k, int)):
                    raise ValueError("'top_k' must be an integer")
                future = server.submit(
                    kind, seq, annotations=body.get("annotations"),
                    deadline_s=(deadline_ms / 1000.0
                                if deadline_ms is not None else None),
                    top_k=top_k, trace_id=self.headers.get("X-PBT-Trace"))
                request_id = getattr(future, "pbt_request_id", None)
                value = future.result()
            except QueueFullError as e:
                self._reply(429, {"error": str(e), "type": "queue_full"},
                            request_id)
            except DeadlineExceededError as e:
                self._reply(504, {"error": str(e), "type": "deadline"},
                            request_id)
            except ServerClosedError as e:
                # Rejected before a future existed: submit() stamps
                # the trace id on the exception instead.
                self._reply(503, {"error": str(e), "type": "closed"},
                            getattr(e, "pbt_request_id", request_id))
            except SequenceTooLongError as e:
                self._reply(400, {"error": str(e), "type": "too_long"},
                            getattr(e, "pbt_request_id", request_id))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"}, request_id)
            except Exception as e:  # noqa: BLE001 — a dispatch-side
                # failure lands on the future; a dropped connection
                # would hide it from the client, so map it to a 500.
                self._reply(500, {"error": f"internal error: {e}",
                                  "type": "internal"}, request_id)
            else:
                self._reply(200, _result_payload(kind, value, top_k),
                            request_id)

    return Handler


def make_http_server(server: Server, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral; read `.server_address[1]`) but do not
    serve — callers run `.serve_forever()` themselves, so shutdown stays
    in their hands."""
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    httpd.daemon_threads = True
    return httpd

"""Thin stdlib JSON/HTTP endpoint over the port's `Server` — a copy of
`proteinbert_tpu/serve/http.py`.

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
  POST /v1/predict_task      {"head_id", "seq", "annotations"?,
                              "deadline_ms"?}
       → {"head_id", "outputs": [...]} — one registered head's float32
         outputs, shaped by its task kind; an unknown or removed head →
         the typed 404 {"type": "unknown_head"}
  POST /v1/neighbors         {"seq", "k"?, "deadline_ms"?}
       → {"neighbors": [[corpus_id, cosine_score], ...]} best-first (a
         server without an index → 400; `k` a positive integer)
  GET  /v1/heads             → {"heads": [{head_id, name, kind,
                               num_outputs}]}
  POST /v1/heads/add         {"head_id"} → loaded from the server's
                             registry against the resident trunk (a head
                             of another trunk → 400 {"type":
                             "trunk_mismatch"})
  POST /v1/heads/remove      {"head_id"} → removed (queued requests for
                             it still complete)
  POST /v1/rollout/load      {"source", "hbm_budget_bytes"?} → load and
                             warm a candidate trunk beside the resident
                             one (through the server's
                             `candidate_loader`); does not fit → 409
                             {"type": "candidate_unfit"}
  POST /v1/rollout/flip      {} → promote the candidate (the old trunk
                             parked on the host, the result cache
                             flushed); no candidate → 409
                             {"type": "no_candidate"}
  POST /v1/rollout/rollback  {} → back to the parked trunk, bit for bit;
                             nothing parked → 409 {"type": "no_candidate"}
  POST /v1/rollout/unload    {} → drop the candidate arm
  GET  /healthz, /stats      → {"ok": true, "mode": "bucketed"|"ragged",
                               "quant": "fp32"|"int8"|"int8_act",
                               "trunk_fingerprint": "...",
                               "stats": {...}}
  GET  /metrics              → Prometheus textfile (the registry's
                               exposition; empty when telemetry is off)
  GET  /metrics.json         → {"replica_id", "snapshot", "windows"} —
                               the registry snapshot plus raw quantile-
                               window values

Shadow traffic: an inference POST with the header `X-PBT-Shadow: 1`
runs through the candidate trunk (`Server.shadow_submit`) synchronously
— the same response shape, but never queued, cached or counted on the
live path; no candidate loaded → 409 {"type": "no_candidate"}. The
fleet router mirrors sampled live requests this way.

Every response to an inference POST carries `X-PBT-Request-Id` when the
server traces (the id of its `serve_request` event); an `X-PBT-Trace`
header joins the request to a caller's trace id.

Typed-error → status mapping (the backpressure contract, visible to
clients): QueueFullError → 429, DeadlineExceededError → 504,
ServerClosedError → 503, UnknownHeadError → 404, CandidateUnfitError /
NoCandidateError → 409,
TrunkMismatchError/SequenceTooLongError/ValueError/bad JSON → 400,
anything else on the future → 500. `ThreadingHTTPServer` gives one
thread per connection; they all funnel into the one scheduler through
Server.submit, so HTTP concurrency IS the micro-batching concurrency.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from proteinbert_tpu_torch.heads.registry import (
    TrunkMismatchError, UnknownHeadError,
)
from proteinbert_tpu_torch.serve.errors import (
    CandidateUnfitError, DeadlineExceededError, NoCandidateError,
    QueueFullError, SequenceTooLongError, ServerClosedError,
)
from proteinbert_tpu_torch.serve.server import Server

_MAX_BODY = 32 * 1024 * 1024  # a seq + an 8943-float annotation vector fit


def _result_payload(kind: str, value, top_k: Optional[int],
                    head_id: Optional[str] = None):
    if kind == "embed":
        return {"global": [float(x) for x in value["global"]],
                "local_mean": [float(x) for x in value["local_mean"]]}
    if kind == "predict_go":
        if top_k is not None:
            return {"top": [[i, p] for i, p in value]}
        return {"probs": [float(x) for x in value]}
    if kind == "predict_task":
        return {"head_id": head_id, "outputs": value.tolist()}
    if kind == "neighbors":
        return {"neighbors": [[i, float(s)]
                              for i, s in value["neighbors"]]}
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
                                  "trunk_fingerprint": server.trunk_fp(),
                                  "stats": server.stats()})
            elif self.path == "/v1/heads":
                self._reply(200, {"heads": server.list_heads()})
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

        def _head_lifecycle(self, add: bool) -> None:
            """POST /v1/heads/{add,remove} on the live server."""
            try:
                body = self._read_body()
                head_id = body["head_id"]
                if not isinstance(head_id, str):
                    raise ValueError("'head_id' must be a string")
                if add:
                    server.add_head(head_id)
                else:
                    server.remove_head(head_id)
            except UnknownHeadError as e:
                self._reply(404, {"error": str(e), "type": "unknown_head"})
            except TrunkMismatchError as e:
                self._reply(400, {"error": str(e),
                                  "type": "trunk_mismatch"})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"})
            else:
                self._reply(200, {"ok": True, "head_id": head_id,
                                  "heads": server.list_heads()})

        def _rollout_control(self, verb: str) -> None:
            """POST /v1/rollout/{load,flip,rollback,unload}: the
            blue-green control plane. Typed 409s: candidate_unfit (the
            memory refusal) and no_candidate (flip or rollback with an
            empty slot)."""
            try:
                if verb != "load":
                    # Read any (ignored) body so keep-alive framing
                    # stays in step.
                    length = int(self.headers.get("Content-Length", 0)
                                 or 0)
                    if length > 0:
                        self.rfile.read(min(length, _MAX_BODY))
                if verb == "load":
                    body = self._read_body()
                    source = body["source"]
                    if not isinstance(source, str):
                        raise ValueError("'source' must be a string")
                    budget = body.get("hbm_budget_bytes")
                    if budget is not None and (
                            isinstance(budget, bool)
                            or not isinstance(budget, int)):
                        raise ValueError(
                            "'hbm_budget_bytes' must be an integer")
                    out = server.load_candidate(source=source,
                                                hbm_budget_bytes=budget)
                elif verb == "flip":
                    out = server.flip()
                elif verb == "rollback":
                    out = server.rollback_trunk()
                else:  # unload
                    out = {"unloaded": server.unload_candidate()}
            except CandidateUnfitError as e:
                self._reply(409, {"error": str(e),
                                  "type": "candidate_unfit"})
            except NoCandidateError as e:
                self._reply(409, {"error": str(e),
                                  "type": "no_candidate"})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"})
            except Exception as e:  # noqa: BLE001 — a loader or
                # placement failure must answer, not drop the connection.
                self._reply(500, {"error": f"internal error: {e}",
                                  "type": "internal"})
            else:
                self._reply(200, {"ok": True, **out})

        def do_POST(self):
            if self.path in ("/v1/heads/add", "/v1/heads/remove"):
                self._head_lifecycle(add=self.path.endswith("/add"))
                return
            if self.path.startswith("/v1/rollout/"):
                verb = self.path[len("/v1/rollout/"):]
                if verb not in ("load", "flip", "rollback", "unload"):
                    self._reply(404,
                                {"error": f"no such route {self.path}"})
                    return
                self._rollout_control(verb)
                return
            route = {"/v1/embed": "embed",
                     "/v1/predict_go": "predict_go",
                     "/v1/predict_residues": "predict_residues",
                     "/v1/predict_task": "predict_task",
                     "/v1/neighbors": "neighbors"}
            kind = route.get(self.path)
            if kind is None:
                self._reply(404, {"error": f"no such route {self.path}"})
                return
            request_id = None
            top_k = None
            head_id = None
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
                if kind == "neighbors":
                    top_k = body.get("k")
                    if top_k is not None and (isinstance(top_k, bool)
                                              or not isinstance(top_k, int)
                                              or top_k < 1):
                        raise ValueError("'k' must be a positive integer")
                elif top_k is not None and (isinstance(top_k, bool)
                                            or not isinstance(top_k, int)):
                    raise ValueError("'top_k' must be an integer")
                if kind == "predict_task":
                    head_id = body["head_id"]
                    if not isinstance(head_id, str):
                        raise ValueError("'head_id' must be a string")
                if self.headers.get("X-PBT-Shadow") == "1":
                    # The router's mirrored copy of a live request: the
                    # candidate arm, synchronously, off the live books.
                    value = server.shadow_submit(
                        kind, seq, annotations=body.get("annotations"),
                        head_id=head_id, top_k=top_k)
                else:
                    future = server.submit(
                        kind, seq, annotations=body.get("annotations"),
                        deadline_s=(deadline_ms / 1000.0
                                    if deadline_ms is not None else None),
                        top_k=top_k, head_id=head_id,
                        trace_id=self.headers.get("X-PBT-Trace"))
                    request_id = getattr(future, "pbt_request_id", None)
                    value = future.result()
            except UnknownHeadError as e:
                # The typed 404: this head is not on this server (never
                # added, or removed); a route 404 has no "type".
                self._reply(404, {"error": str(e), "type": "unknown_head"},
                            getattr(e, "pbt_request_id", request_id))
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
            except NoCandidateError as e:
                # A shadow asked of an empty candidate slot (a race with
                # unload or flip): the mirror records it, the live books
                # do not.
                self._reply(409, {"error": str(e),
                                  "type": "no_candidate"}, request_id)
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}",
                                  "type": "bad_request"}, request_id)
            except Exception as e:  # noqa: BLE001 — a dispatch-side
                # failure lands on the future; a dropped connection
                # would hide it from the client, so map it to a 500.
                self._reply(500, {"error": f"internal error: {e}",
                                  "type": "internal"}, request_id)
            else:
                self._reply(200, _result_payload(kind, value, top_k,
                                                 head_id), request_id)

    return Handler


class _BurstHTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 resets the connections of a
    # burst (a fleet router fanning out a hundred clients at once); the
    # handler threads, not the backlog, are what bounds concurrency.
    request_queue_size = 1024


def make_http_server(server: Server, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral; read `.server_address[1]`) but do not
    serve — callers run `.serve_forever()` themselves, so shutdown stays
    in their hands. The listen backlog is 1024 connections (the JAX
    shim's is socketserver's 5)."""
    httpd = _BurstHTTPServer((host, port), make_handler(server))
    httpd.daemon_threads = True
    return httpd

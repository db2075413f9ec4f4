"""HTTP inference server over :class:`mopoe_mimic_tpu_torch.serve.InferenceSession`.

Port of ``mopoe_mimic_tpu/serve_http.py``: the same endpoints, wire
format, caps and backpressure, over the port's session, which serves a run
directory of the port's training CLI on the card (``--device cuda``, the
default) or, when asked, the CPU. No reference counterpart — the
reference stops at offline eval; this is the network-facing half of the
serving surface (serve.py is the in-process half). Stdlib-only
(``http.server``): no web framework to install, nothing beyond numpy on
the client.

Wire format
-----------
Arrays travel as ``.npz`` bodies (``numpy.savez_compressed``) with
``Content-Type: application/x-npz``; scalars travel in the query string.
Nested outputs flatten their key paths with ``/`` (e.g. conditional
generation's ``{subset: {modality: array}}`` becomes ``PA_text/PA``).
Compact mode (``?compact=1``) converts on the device — text as int token
ids, images as uint8 — and shrinks the HTTP payload with the device
download.

Endpoints
---------
  GET  /healthz                     liveness + model manifest (JSON)
  POST /generate?num_samples&seed&compact      → npz {modality: array}
  POST /encode         (npz batch) → npz {subsets/KEY/mu|logvar, joint/...}
  POST /cond_generate?seed&compact (npz batch) → npz {subset/modality}
  POST /text_array     (JSON ["report", ...]) → npz {text}
  POST /decode_text    (npz {text: ids|probs}) → JSON [str|tokens]

Each request runs on its own handler thread, up to ``--max_inflight`` at
once; batch-size bucketing inside InferenceSession keeps the shapes the
card sees to a few.

Scope & limits
--------------
This is a RESEARCH endpoint for driving a trained model interactively /
from notebooks — not a hardened production frontend. It binds to
localhost by default, speaks plain HTTP, and has no auth. What it does
enforce (so a stray client can't wedge the process):

  * request bodies above ``--max_body_mb`` (default 64) → 413
  * more than ``--max_inflight`` concurrently executing requests
    (default 8) → 503 after a short wait — backpressure instead of an
    unbounded thread pile-up in ThreadingHTTPServer
  * ``/generate?num_samples`` above ``--max_samples`` (default 512) → 400

Put a real reverse proxy (TLS, auth, rate limits) in front for anything
beyond a trusted lab network.

CLI:
    python -m mopoe_mimic_tpu_torch.serve_http --run_dir DIR --port 8000 [--device cuda]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Mapping, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.utils.logger import log

NPZ_TYPE = "application/x-npz"


def _npz_bytes(arrays: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _read_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'b': arr}} → {'a/b': arr}; tuples index numerically."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix.rstrip("/"): np.asarray(tree)}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


class _Handler(BaseHTTPRequestHandler):
    # the session is attached to the server object by serve()
    protocol_version = "HTTP/1.1"

    # -- plumbing --------------------------------------------------------

    def log_message(self, fmt, *args):  # route to the framework logger
        log.debug("http: " + fmt % args)

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: Any) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _npz(self, arrays: Mapping[str, np.ndarray]) -> None:
        self._reply(200, _npz_bytes(arrays), NPZ_TYPE)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _body_too_large(self) -> bool:
        """413 + drain-free close for oversized requests (size cap)."""
        limit = getattr(self.server, "max_body_bytes", 64 * 1024 * 1024)
        n = int(self.headers.get("Content-Length") or 0)
        if n <= limit:
            return False
        self._json(413, {
            "error": f"request body {n} bytes exceeds limit {limit}"
        })
        self.close_connection = True  # don't read the oversized body
        return True

    def _q(self, query: Dict[str, list], key: str, default=None, cast=str):
        vals = query.get(key)
        return cast(vals[0]) if vals else default

    # -- endpoints ---------------------------------------------------------

    def do_GET(self):  # noqa: N802 (http.server API)
        if urlparse(self.path).path != "/healthz":
            return self._json(404, {"error": f"unknown path {self.path}"})
        sess: InferenceSession = self.server.session  # type: ignore[attr-defined]
        cfg = sess.cfg
        self._json(200, {
            "status": "ok",
            "epoch": sess.epoch,
            "buckets": list(sess.buckets),
            "model": {
                "method": cfg.method, "img_size": cfg.img_size,
                "text_encoding": cfg.text_encoding,
                "len_sequence": cfg.len_sequence, "class_dim": cfg.class_dim,
                "modalities": list(cfg.modality_names),
            },
        })

    def do_POST(self):  # noqa: N802
        sess: InferenceSession = self.server.session  # type: ignore[attr-defined]
        url = urlparse(self.path)
        query = parse_qs(url.query)
        if self._body_too_large():
            return None
        # bounded concurrency: beyond max_inflight executing requests,
        # shed load with 503 instead of stacking handler threads
        gate = getattr(self.server, "inflight_gate", None)
        if gate is not None and not gate.acquire(timeout=getattr(
                self.server, "inflight_wait_s", 5.0)):
            return self._json(503, {"error": "server busy — retry later"})
        try:
            return self._do_post(sess, url, query)
        finally:
            if gate is not None:
                gate.release()

    def _do_post(self, sess, url, query):
        seed = self._q(query, "seed", 0, int)
        compact = bool(self._q(query, "compact", 0, int))
        try:
            if url.path == "/generate":
                n = self._q(query, "num_samples", 16, int)
                cap = getattr(self.server, "max_samples", 512)
                if not 0 < n <= cap:
                    return self._json(400, {
                        "error": f"num_samples must be in [1, {cap}], got {n}"
                    })
                out = sess.generate(n, seed=seed, compact=compact)
                return self._npz(out)
            if url.path == "/encode":
                batch = _read_npz(self._body())
                return self._npz(_flatten(sess.encode(batch)))
            if url.path == "/cond_generate":
                batch = _read_npz(self._body())
                out = sess.cond_generate(batch, seed=seed, compact=compact)
                return self._npz(_flatten(out))
            if url.path == "/text_array":
                reports = json.loads(self._body().decode())
                return self._npz({"text": sess.text_array(reports)})
            if url.path == "/decode_text":
                arrays = _read_npz(self._body())
                return self._json(200, sess.decode_text(arrays["text"]))
            return self._json(404, {"error": f"unknown path {url.path}"})
        except Exception as e:  # noqa: BLE001 — a bad request must not kill the server
            log.warning(f"http {url.path} failed: {e!r}", exc_info=True)
            return self._json(400, {"error": repr(e)})


class InferenceServer:
    """A running HTTP server around an InferenceSession.

    ``start()`` binds and serves on a daemon thread (port 0 picks an
    ephemeral port — ``self.port`` reports the bound one); context-manager
    use tears it down. One server per process/device; concurrency comes
    from the threading server's per-request threads; the card orders their
    work on its one stream.
    """

    def __init__(self, session: InferenceSession, host: str = "127.0.0.1",
                 port: int = 8000, max_body_mb: int = 64,
                 max_inflight: int = 8, max_samples: int = 512,
                 inflight_wait_s: float = 5.0):
        self.session = session
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.session = session  # type: ignore[attr-defined]
        self._httpd.max_body_bytes = max_body_mb * 1024 * 1024  # type: ignore[attr-defined]
        self._httpd.max_samples = max_samples  # type: ignore[attr-defined]
        self._httpd.inflight_gate = threading.Semaphore(max_inflight)  # type: ignore[attr-defined]
        self._httpd.inflight_wait_s = inflight_wait_s  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self.host, self.port = self._httpd.server_address[:2]

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._thread.start()
        log.info(f"serving on http://{self.host}:{self.port} "
                 f"(epoch {self.session.epoch})")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

    def serve_forever(self) -> None:
        log.info(f"serving on http://{self.host}:{self.port} "
                 f"(epoch {self.session.epoch}) — ctrl-c to stop")
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._httpd.server_close()

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--max_body_mb", type=int, default=64)
    ap.add_argument("--max_inflight", type=int, default=8)
    ap.add_argument("--max_samples", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="the card (default), or cpu when asked for; no fallback")
    args = ap.parse_args(argv)
    sess = InferenceSession(run_dir=args.run_dir, epoch=args.epoch, device=args.device)
    # one request up front, so the first client does not pay for cuDNN's
    # first plans and the kernels' loading
    sess.generate(1)
    InferenceServer(
        sess, host=args.host, port=args.port, max_body_mb=args.max_body_mb,
        max_inflight=args.max_inflight, max_samples=args.max_samples,
    ).serve_forever()


if __name__ == "__main__":
    main()

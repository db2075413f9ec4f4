"""The port's HTTP serving layer (mopoe_mimic_tpu_torch/serve_http.py): the
ten cases of tests/test_serve_http.py against the port's server on the CPU.
Drives a real ThreadingHTTPServer on an ephemeral localhost port through
urllib and asserts the npz wire format round-trips against the in-process
session, whose weights are the port's seeded initialisation."""

import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.serve_http import InferenceServer, _flatten, _npz_bytes


def _cfg(**kw):
    base = dict(
        method="joint_elbo", dataset="testing", batch_size=4, class_dim=4,
        DIM_img=2, DIM_text=2, img_size=64, text_encoding="word",
        vocab_size=30, compute_dtype="float32",
    )
    base.update(kw)
    return MopoeConfig(**base)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models (as
    tests/test_torch_port_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(cfg, buckets):
    """The port's session on the CPU, the batch of the JAX test's
    BatchLoader (the dataset's first rows, images NHWC)."""
    torch.manual_seed(0)
    sess = InferenceSession(cfg, device="cpu", buckets=buckets)
    ds = SyntheticMimic(cfg, seed=0)
    return sess, {k: v[:cfg.batch_size] for k, v in ds.arrays.items()}


@pytest.fixture(scope="module")
def server():
    sess, batch = _session(_cfg(), (2, 4))
    with InferenceServer(sess, port=0) as srv:  # port 0 → ephemeral
        yield srv, sess, batch


def _get(srv, path):
    with urllib.request.urlopen(f"http://{srv.host}:{srv.port}{path}") as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _post(srv, path, body=b"", ctype="application/x-npz"):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}{path}", data=body, method="POST",
        headers={"Content-Type": ctype},
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _load_npz(body):
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def test_healthz_reports_model_manifest(server):
    srv, sess, _ = server
    status, body, ctype = _get(srv, "/healthz")
    assert status == 200 and ctype == "application/json"
    info = json.loads(body)
    assert info["status"] == "ok"
    assert info["model"]["img_size"] == 64
    assert set(info["model"]["modalities"]) == {"PA", "Lateral", "text"}
    assert info["buckets"] == [2, 4]


def test_generate_matches_in_process_session(server):
    srv, sess, _ = server
    status, body, ctype = _post(srv, "/generate?num_samples=5&seed=3")
    assert status == 200 and ctype == "application/x-npz"
    out = _load_npz(body)
    want = sess.generate(5, seed=3)
    assert set(out) == set(want)
    for m in want:
        np.testing.assert_allclose(out[m], want[m], rtol=1e-6, atol=1e-6)


def test_generate_compact_wire(server):
    srv, sess, _ = server
    _, body, _ = _post(srv, "/generate?num_samples=3&seed=1&compact=1")
    out = _load_npz(body)
    assert out["text"].dtype == np.int32
    assert out["PA"].dtype == np.uint8
    # compact payloads are much smaller on the wire too
    _, full_body, _ = _post(srv, "/generate?num_samples=3&seed=1")
    assert len(body) < len(full_body)


def test_encode_round_trip(server):
    srv, sess, batch = server
    small = {k: np.asarray(v)[:3] for k, v in batch.items()}
    status, body, _ = _post(srv, "/encode", _npz_bytes(small))
    assert status == 200
    out = _load_npz(body)
    want = _flatten(sess.encode(small))
    assert set(out) == set(want)
    np.testing.assert_allclose(
        out["joint/0"], want["joint/0"], rtol=1e-5, atol=1e-5)
    assert out["subsets/Lateral_PA_text/0"].shape == (3, 4)


def test_cond_generate_flattens_subsets(server):
    srv, sess, batch = server
    small = {k: np.asarray(v)[:2] for k, v in batch.items()}
    status, body, _ = _post(srv, "/cond_generate?seed=2", _npz_bytes(small))
    assert status == 200
    out = _load_npz(body)
    # 7 subsets × 3 modalities
    assert len(out) == 21
    assert out["PA_text/Lateral"].shape == (2, 64, 64, 1)
    want = sess.cond_generate(small, seed=2)
    np.testing.assert_allclose(
        out["PA_text/Lateral"], want["PA_text"]["Lateral"],
        rtol=1e-6, atol=1e-6)


def test_bad_requests_return_errors_not_crashes(server):
    srv, _, _ = server
    status, body, _ = _post(srv, "/nope")
    assert status == 404
    status, body, _ = _post(srv, "/encode", b"not an npz")
    assert status == 400
    assert "error" in json.loads(body)
    # server still alive afterwards
    status, _, _ = _get(srv, "/healthz")
    assert status == 200


def test_char_text_endpoints_round_trip():
    sess, _ = _session(_cfg(text_encoding="char"), (2,))
    with InferenceServer(sess, port=0) as srv:
        status, body, _ = _post(
            srv, "/text_array", json.dumps(["no acute findings"]).encode(),
            ctype="application/json")
        assert status == 200
        arr = _load_npz(body)["text"]
        assert arr.shape == (1, 1024, 71)
        status, body, _ = _post(srv, "/decode_text", _npz_bytes({"text": arr}))
        assert status == 200
        decoded = json.loads(body)
        assert decoded[0].startswith("no acute findings$")


def test_request_size_cap(server):
    """Bodies above max_body_mb are rejected with 413 before being read."""
    srv, sess, batch = server
    srv._httpd.max_body_bytes = 1024  # shrink the cap for the test
    try:
        big = b"x" * 4096
        code, body, _ = _post(srv, "/encode", body=big)
        assert code == 413
        assert b"exceeds limit" in body
    finally:
        srv._httpd.max_body_bytes = 64 * 1024 * 1024


def test_generate_num_samples_cap(server):
    srv, sess, batch = server
    code, body, _ = _post(srv, "/generate?num_samples=100000")
    assert code == 400
    assert b"num_samples" in body
    code, body, _ = _post(srv, "/generate?num_samples=0")
    assert code == 400


def test_inflight_backpressure(server):
    """When max_inflight requests are already executing, the next request
    sheds with 503 instead of piling up handler threads."""
    import threading as th
    import time

    srv, sess, batch = server
    release = th.Event()
    orig_generate = sess.generate

    def slow_generate(n, seed=0, compact=False):
        release.wait(timeout=30)
        return orig_generate(n, seed=seed, compact=compact)

    gate = th.Semaphore(1)  # single-slot gate
    old_gate = srv._httpd.inflight_gate
    old_wait = srv._httpd.inflight_wait_s
    srv._httpd.inflight_gate = gate
    srv._httpd.inflight_wait_s = 0.2
    sess.generate = slow_generate
    try:
        results = {}

        def first():
            results["first"] = _post(srv, "/generate?num_samples=2")

        t = th.Thread(target=first)
        t.start()
        time.sleep(0.3)  # let the first request occupy the slot
        code, body, _ = _post(srv, "/generate?num_samples=2")
        assert code == 503
        assert b"busy" in body
        release.set()
        t.join(timeout=30)
        assert results["first"][0] == 200  # the occupant completed fine
    finally:
        sess.generate = orig_generate
        srv._httpd.inflight_gate = old_gate
        srv._httpd.inflight_wait_s = old_wait
        release.set()

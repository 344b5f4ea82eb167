"""The port's serving daemon (``vit_with_opencl_tpu_torch.serve``) on the CPU.

Mirrors the 14 cases of ``tests/test_serve.py`` on the port's engine
(``device="cpu"``, fp32, the toy ``srv`` config; the data-parallel engine
on ``["cpu"] * 8``), with the probabilities held to the JAX package's
golden model within 1e-4. Adds: the JAX package's client (``classify``,
``stats``) against the port's server, which proves one wire format; the
port's wire parser against JAX's on float32 and uint8 payloads and its
errors; ``main`` as a user starts it; the engines' ``tuning_path`` refusal.

Every socket has a 30-s default timeout (module fixture), every join a
bound and every server a ``shutdown`` in ``finally``, so a hang fails a
test instead of running the suite into its time limit.
"""

import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    # The xdist workers share the host's cores: one torch thread each.
    torch.set_num_threads(1)

from vit_with_opencl_tpu import ViTConfig as JViTConfig
from vit_with_opencl_tpu import serve as jserve
from vit_with_opencl_tpu.harness import fixtures as jfixtures
from vit_with_opencl_tpu.io import binfmt as jbinfmt
from vit_with_opencl_tpu.models import golden as jgolden
from vit_with_opencl_tpu_torch import ViTConfig, serve
from vit_with_opencl_tpu_torch import config as config_lib
from vit_with_opencl_tpu_torch.engine import DataParallelEngine, InferenceEngine
from vit_with_opencl_tpu_torch.harness import fixtures
from vit_with_opencl_tpu_torch.io import binfmt
from vit_with_opencl_tpu_torch.io.preprocess import IMAGENET_MEAN, IMAGENET_STD

CFG_KW = dict(name="srv", img_size=32, patch_size=8, embed_dim=48, depth=1,
              num_heads=4, num_classes=7)
JCFG, CFG = JViTConfig(**CFG_KW), ViTConfig(**CFG_KW)
CPUS = ["cpu"] * 8
F32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
PROB_TOL = 1e-4  # fp32 against the golden model, as tests/test_serve.py
JOIN_S = 120


@pytest.fixture(scope="module", autouse=True)
def socket_timeout():
    before = socket.getdefaulttimeout()
    socket.setdefaulttimeout(30)
    yield
    socket.setdefaulttimeout(before)


@pytest.fixture(scope="module")
def server():
    params = fixtures.random_params(CFG, seed=0, scale=0.05)
    engine = InferenceEngine(CFG, params, batch_size=4, device="cpu", **F32)
    engine.warmup()
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=20.0)
    srv.start_background()
    try:
        yield srv, params
    finally:
        srv.shutdown()


def _expected(params, images):
    probs = jgolden.golden_forward(images, params, JCFG)
    return [(int(p.argmax()), float(p.max())) for p in probs]


def _normalized(raw):
    return ((raw.astype(np.float32) / 255.0 - IMAGENET_MEAN.reshape(1, 3, 1, 1))
            / IMAGENET_STD.reshape(1, 3, 1, 1)).astype(np.float32)


def _assert_matches(got, want, tol=PROB_TOL):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) < tol


def _join_all(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def test_single_request(server):
    srv, params = server
    images = fixtures.random_images(CFG, n=2, seed=1)
    _assert_matches(serve.classify(images, port=srv.address[1]),
                    _expected(params, images))


def test_concurrent_requests_are_batched(server):
    srv, params = server
    before = srv.batcher.batches_run
    images = fixtures.random_images(CFG, n=8, seed=2)
    results_out = [None] * 8

    def worker(i):
        results_out[i] = serve.classify(images[i : i + 1], port=srv.address[1])[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    _join_all(threads)
    want = _expected(params, images)
    assert [r[0] for r in results_out] == [w[0] for w in want]
    # 8 images through a batch-4 engine: must have coalesced (< 8 batches).
    assert srv.batcher.batches_run - before < 8


def test_bad_shape_reports_error(server):
    srv, _ = server
    wrong = np.zeros((1, 3, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="ERROR: expected images"):
        serve.classify(wrong, port=srv.address[1])


def test_garbage_payload_keeps_server_alive(server):
    srv, params = server
    with socket.create_connection(("127.0.0.1", srv.address[1])) as sock:
        payload = b"not an image binary at all"
        sock.sendall(struct.pack("<I", len(payload)) + payload)
        msg = serve._recv_msg(sock).decode()
        assert msg.startswith("ERROR:")
    images = fixtures.random_images(CFG, n=1, seed=3)
    got = serve.classify(images, port=srv.address[1])
    assert got[0][0] == _expected(params, images)[0][0]


def test_engine_failure_fails_request_but_daemon_survives(server, monkeypatch):
    """One bad batch must not brick the batcher or hang its clients."""
    srv, params = server
    original = srv.batcher.engine.run
    calls = {"n": 0}

    def flaky(images):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FloatingPointError("injected failure")
        return original(images)

    errors_before = srv.batcher.batch_errors
    monkeypatch.setattr(srv.batcher.engine, "run", flaky)
    images = fixtures.random_images(CFG, n=1, seed=9)
    with pytest.raises(RuntimeError, match="inference failed: injected failure"):
        serve.classify(images, port=srv.address[1])
    assert srv.batcher.batch_errors == errors_before + 1
    got = serve.classify(images, port=srv.address[1])
    assert got[0][0] == _expected(params, images)[0][0]


def test_multi_image_payload_single_batch(server):
    """An n-image payload coalesces into ceil(n/bs) batches, not n."""
    srv, params = server
    before = srv.batcher.batches_run
    images = fixtures.random_images(CFG, n=4, seed=10)  # == engine batch size
    got = serve.classify(images, port=srv.address[1])
    assert [g[0] for g in got] == [w[0] for w in _expected(params, images)]
    assert srv.batcher.batches_run - before == 1


def test_uint8_serving_end_to_end():
    """uint8 wire mode: raw pixels in, normalization on the device — the
    golden model on host-normalized pixels; a float payload is refused."""
    params = fixtures.random_params(CFG, seed=2, scale=0.05)
    engine_u8 = InferenceEngine(CFG, params, batch_size=2, device="cpu",
                                normalize_uint8=True, **F32)
    srv = serve.InferenceServer(engine_u8, port=0, max_wait_ms=10.0)
    srv.start_background()
    try:
        raw = np.random.default_rng(0).integers(
            0, 256, (2, 3, CFG.img_size, CFG.img_size), np.uint8)
        norm = _normalized(raw)
        _assert_matches(serve.classify(raw, port=srv.address[1]),
                        _expected(params, norm))
        with pytest.raises(RuntimeError, match="does not match"):
            serve.classify(norm, port=srv.address[1])
    finally:
        srv.shutdown()


def test_w8a8_serving_end_to_end():
    """``quantize="int8-w8a8"`` behind the daemon: within the comparator's
    0.01 of the fp32 golden model, the same top-1."""
    params = fixtures.random_params(CFG, seed=3, scale=0.05)
    engine_q = InferenceEngine(CFG, params, batch_size=4, device="cpu",
                               quantize="int8-w8a8", **F32)
    srv = serve.InferenceServer(engine_q, port=0, max_wait_ms=10.0)
    srv.start_background()
    try:
        images = fixtures.random_images(CFG, n=4, seed=4)
        _assert_matches(serve.classify(images, port=srv.address[1]),
                        _expected(params, images), tol=1e-2)
    finally:
        srv.shutdown()


def test_stats_request(server):
    srv, _ = server
    images = fixtures.random_images(CFG, n=2, seed=5)
    serve.classify(images, port=srv.address[1])
    s = serve.stats(port=srv.address[1])
    assert s["images_served"] >= 2
    assert s["batches_run"] >= 1
    assert s["config"] == CFG.name
    assert s["batch_size"] == 4
    assert s["n_devices"] == 1
    assert s["queue_depth"] == 0
    assert s["uptime_s"] >= 0


def test_stats_count_a_batch_before_its_clients_are_answered(server, monkeypatch):
    """STATS read at once after ``classify`` returns counts that request's
    images. Each answer's wake-up is followed by a 50-ms pause of the
    batcher's thread, so a batcher that counted after waking its waiters
    would be read before it counts."""

    class SlowEvent(threading.Event):
        def set(self):
            super().set()
            time.sleep(0.05)

    class SlowRequest(serve._Request):
        def __init__(self, image):
            super().__init__(image)
            self.event = SlowEvent()

    monkeypatch.setattr(serve, "_Request", SlowRequest)
    srv, _ = server
    port = srv.address[1]
    before = serve.stats(port=port)
    images = fixtures.random_images(CFG, n=2, seed=12)
    for k in range(1, 4):
        serve.classify(images, port=port)
        s = serve.stats(port=port)
        assert s["images_served"] == before["images_served"] + 2 * k
        assert before["batches_run"] + k <= s["batches_run"] <= before["batches_run"] + 2 * k


def test_jax_client_gets_the_port_clients_answers(server):
    """The JAX package's ``classify`` and ``stats`` against the port's
    server: the same answers as the port's own client (one wire format)."""
    srv, params = server
    images = fixtures.random_images(CFG, n=3, seed=11)
    port_got = serve.classify(images, port=srv.address[1])
    jax_got = jserve.classify(images, port=srv.address[1])
    assert jax_got == port_got
    _assert_matches(jax_got, _expected(params, images))
    assert jserve.stats(port=srv.address[1]).keys() == \
        serve.stats(port=srv.address[1]).keys()
    with pytest.raises(RuntimeError, match="ERROR: expected images"):
        jserve.classify(np.zeros((1, 3, 8, 8), np.float32), port=srv.address[1])


def test_dp_fanout_serving_end_to_end():
    """``DataParallelEngine`` behind the daemon: a coalesced batch split over
    8 CPU devices."""
    params = fixtures.random_params(CFG, seed=3, scale=0.05)
    engine = DataParallelEngine(CFG, params, batch_size=8, devices=CPUS, **F32)
    assert engine.n_devices == 8
    engine.warmup()
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=50.0)
    srv.start_background()
    try:
        images = fixtures.random_images(CFG, n=8, seed=4)
        _assert_matches(serve.classify(images, port=srv.address[1]),
                        _expected(params, images))
        s = serve.stats(port=srv.address[1])
        assert s["n_devices"] == 8
        assert s["images_served"] >= 8
    finally:
        srv.shutdown()


def test_dp_engine_batch_divisibility(tmp_path, monkeypatch):
    """``serve.main --dp 3`` with a batch of 8 refuses before it listens."""
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    params = jfixtures.random_params(JCFG, seed=3, scale=0.05)
    jbinfmt.save_weights(tmp_path / "Network",
                         jfixtures.params_to_positional(params, JCFG), JCFG)
    # Were the engine built, main would listen forever: make that a failure.
    monkeypatch.setattr(serve.InferenceServer, "__init__", None)
    with pytest.raises(ValueError, match="not divisible"):
        serve.main(["--weights", str(tmp_path / "Network"), "--config", CFG.name,
                    "--port", "0", "--batch-size", "8", "--dp", "3",
                    "--device", "cpu"])


def test_uint8_dp_serving_end_to_end():
    """uint8 wire mode with data-parallel fan-out: raw pixels split over
    the devices and normalized on each."""
    params = fixtures.random_params(CFG, seed=2, scale=0.05)
    engine = DataParallelEngine(CFG, params, batch_size=8, devices=CPUS,
                                normalize_uint8=True, **F32)
    engine.warmup()
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=50.0)
    srv.start_background()
    try:
        raw = np.random.default_rng(1).integers(
            0, 256, (8, 3, CFG.img_size, CFG.img_size), np.uint8)
        norm = _normalized(raw)
        _assert_matches(serve.classify(raw, port=srv.address[1]),
                        _expected(params, norm))
        with pytest.raises(RuntimeError, match="does not match"):
            serve.classify(norm, port=srv.address[1])
        assert serve.stats(port=srv.address[1])["n_devices"] == 8
    finally:
        srv.shutdown()


def test_dp_engine_uint8_dtype_guards():
    """The DP engines' dtype guards reach a batcher's waiters as failed
    requests, and each batcher serves on afterwards."""
    params = fixtures.random_params(CFG, seed=3, scale=0.05)
    floats = np.zeros((3, CFG.img_size, CFG.img_size), np.float32)
    pixels = floats.astype(np.uint8)
    for normalize_uint8, wrong, right, match in (
            (True, floats, pixels, "expects raw"),
            (False, pixels, floats, "preprocess first")):
        eng = DataParallelEngine(CFG, params, batch_size=8, devices=CPUS,
                                 normalize_uint8=normalize_uint8, **F32)
        batcher = serve.Batcher(eng, max_wait_ms=1.0)
        try:
            with pytest.raises(RuntimeError, match=f"inference failed: .*{match}"):
                batcher.submit(wrong)
            assert batcher.batch_errors == 1
            label, prob = batcher.submit(right)
            assert 0 <= label < CFG.num_classes and 0 < prob <= 1
            assert batcher.batches_run == 1
        finally:
            batcher.stop()


def test_concurrent_stress_mixed_sizes_uint8_dp():
    """Many client threads firing mixed-size uint8 payloads at a DP daemon:
    every response matches the golden model for exactly the images that
    request sent, in order; latency bounded; STATS consistent afterwards."""
    params = fixtures.random_params(CFG, seed=7, scale=0.05)
    engine = DataParallelEngine(CFG, params, batch_size=8, devices=CPUS,
                                normalize_uint8=True, **F32)
    engine.warmup()
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=5.0)
    srv.start_background()
    switch = None
    try:
        # Distinct images with precomputed golden answers, so any
        # cross-request swap flips a top-1 and is caught.
        pool = np.random.default_rng(2).integers(
            0, 256, (16, 3, CFG.img_size, CFG.img_size), np.uint8)
        want = _expected(params, _normalized(pool))
        n_threads, reqs_per_thread = 6, 5
        sizes = [1, 2, 3, 5, 8]
        errors: list = []
        latencies: list = []
        lock = threading.Lock()

        def client(tid):
            rng = np.random.default_rng(100 + tid)
            try:
                for r in range(reqs_per_thread):
                    n = sizes[(tid + r) % len(sizes)]
                    idx = rng.choice(len(pool), size=n, replace=False)
                    t0 = time.perf_counter()
                    got = serve.classify(pool[idx], port=srv.address[1])
                    dt = time.perf_counter() - t0
                    if len(got) != n:
                        raise AssertionError(f"got {len(got)} results for {n}")
                    for j, k in enumerate(idx):
                        if got[j][0] != want[k][0] or abs(got[j][1] - want[k][1]) >= PROB_TOL:
                            raise AssertionError(
                                f"thread {tid} req {r} img {j}: {got[j]} != "
                                f"golden {want[k]} (cross-request corruption)")
                    with lock:
                        latencies.append(dt)
            except Exception as e:  # reported by the main thread
                with lock:
                    errors.append((tid, e))

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)  # more interleavings of the threads
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert not errors, errors[:3]
        assert len(latencies) == n_threads * reqs_per_thread
        assert max(latencies) < 30.0, f"max latency {max(latencies):.1f}s"
        s = serve.stats(port=srv.address[1])
        sent = sum(sizes[(tid + r) % len(sizes)]
                   for tid in range(n_threads) for r in range(reqs_per_thread))
        assert s["images_served"] == sent
        assert s["batch_errors"] == 0
        assert s["queue_depth"] == 0
        assert s["batches_run"] < sent  # coalescing happened
    finally:
        if switch is not None:
            sys.setswitchinterval(switch)
        srv.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_wire_parser_matches_jax(dtype):
    rng = np.random.default_rng(12)
    if dtype == "uint8":
        images = rng.integers(0, 256, (3, 3, 5, 4), np.uint8)
        body = images.tobytes()
    else:
        images = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
        body = images.astype("<f4").tobytes()
    payload = np.asarray(images.shape, "<i4").tobytes() + body
    got = binfmt.load_image_data_bytes(payload)
    want = jbinfmt.load_image_data_bytes(payload)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, images)
    got[0, 0, 0, 0] = 1  # a writable copy, not a view of the payload


@pytest.mark.parametrize("payload", [
    b"\x01\x00",
    np.asarray([0, 3, 2, 2], "<i4").tobytes(),
    np.asarray([1, 3, 2, 2], "<i4").tobytes() + b"\x00" * 7,
], ids=["truncated_header", "bad_header", "bad_body"])
def test_wire_parser_errors_match_jax(payload):
    with pytest.raises(ValueError) as port_err:
        binfmt.load_image_data_bytes(payload)
    with pytest.raises(ValueError) as jax_err:
        jbinfmt.load_image_data_bytes(payload)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dp", ["1", "2"])
def test_main_serves_until_interrupted(dp, tmp_path, monkeypatch, capsys):
    """``serve.main`` as a user starts it (``--device cpu``; ``--dp 2`` the
    data-parallel engine): warm-up before the server, answers equal to the
    same engine's ``run``, a clean stop on an interrupt."""
    monkeypatch.setitem(config_lib.PRESETS, CFG.name, CFG)
    params = jfixtures.random_params(JCFG, seed=5, scale=0.05)
    jbinfmt.save_weights(tmp_path / "Network",
                         jfixtures.params_to_positional(params, JCFG), JCFG)
    images = fixtures.random_images(CFG, n=3, seed=6)
    seen = {}

    def serve_forever(self):
        self.start_background()
        seen["got"] = serve.classify(images, port=self.address[1])
        seen["stats"] = serve.stats(port=self.address[1])
        raise KeyboardInterrupt

    monkeypatch.setattr(serve.InferenceServer, "serve_forever", serve_forever)
    rc = serve.main(["--weights", str(tmp_path / "Network"), "--config", CFG.name,
                     "--port", "0", "--batch-size", "2", "--device", "cpu",
                     "--dp", dp])
    assert rc == 0
    assert "serving srv on ('127.0.0.1'" in capsys.readouterr().out
    rounded = {k: binfmt.round_6dp(v) for k, v in params.items()}
    want = InferenceEngine(CFG, rounded, batch_size=2, device="cpu",
                           attention_impl="flash").run(images)
    assert [g[0] for g in seen["got"]] == [int(p.argmax()) for p in want]
    for (_, prob), p in zip(seen["got"], want):
        assert abs(prob - float(p.max())) < 1e-3
    assert seen["stats"]["n_devices"] == int(dp)
    assert seen["stats"]["images_served"] == 3


@pytest.mark.parametrize("engine_cls", [InferenceEngine, DataParallelEngine])
def test_engines_refuse_the_tuning_cache(engine_cls, tmp_path):
    """Once refused, the autotune cache is now read, as JAX's engines read
    it (so the daemon's engines get it): the entry of the batch of one
    device (8, or 8 over 8 devices), recorded on the CPU, is the engine's
    tuning and binds its kernel table's key tile; at T = 17 the tile moves
    nothing, so the answers equal the untuned engine's."""
    from vit_with_opencl_tpu_torch.perf import autotune

    params = fixtures.random_params(CFG, seed=3, scale=0.05)
    kw = {"devices": CPUS} if engine_cls is DataParallelEngine else {"device": "cpu"}
    kw["attention_impl"] = "flash"
    per_device = 8 // (len(CPUS) if engine_cls is DataParallelEngine else 1)
    path = tmp_path / "knobs.json"
    autotune.save_tuning(path, autotune.tuning_key(CFG, per_device, torch.float32),
                         {"blockwise_block_k": 256, "device": "cpu"})
    eng = engine_cls(CFG, params, batch_size=8, tuning_path=str(path), **F32, **kw)
    assert eng.tuning["blockwise_block_k"] == 256
    assert eng.kernels["attention_packed"].keywords["block_k"] == 256
    images = fixtures.random_images(CFG, n=8, seed=4)
    plain = engine_cls(CFG, params, batch_size=8, tuning_path=str(tmp_path / "none.json"),
                       **F32, **kw)
    assert plain.tuning == {}
    np.testing.assert_array_equal(eng.run(images), plain.run(images))

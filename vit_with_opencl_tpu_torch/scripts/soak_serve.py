"""Sustained serving soak THROUGH THE SOCKET: concurrent clients pumping
uint8 payloads at the dynamic-batching daemon for a fixed duration.

Counterpart of ``scripts/soak_serve.py``. Unlike ``soak`` (which loops the
forward directly), this exercises the full serving path — wire protocol,
batcher coalescing, the upload, uint8 normalization on the device, the
encoder's kernels (``flash``), result formatting — under sustained
concurrent load, and reports aggregate img/s, per-request latency
percentiles (host clock, from send to the parsed reply), and the daemon's
own STATS counters. The weights are ``harness.fixtures.random_params`` (seed
0, scale 0.05), as in the JAX script.

Usage: python -m vit_with_opencl_tpu_torch.scripts.soak_serve [config]
       [batch] [seconds] [clients] [quant]
(quant: int8-w8a8 (default), int8, auto, or none / bf16)
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Optional

import numpy as np

from .. import get_config, serve
from ..engine import InferenceEngine
from ..harness import fixtures


def percentile_ms(lat_ms: np.ndarray, q: int) -> Optional[float]:
    """The ``q``-th percentile of sorted latencies, or None where the sample
    is too small to hold one: fewer than 100 / (100 - q) requests (p99
    needs 100, p95 20), so that at least one request lies above it."""
    if len(lat_ms) < 100 / (100 - q):
        return None
    return float(lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * q / 100))])


def _ms(value: Optional[float]) -> str:
    return "n/a (too few requests)" if value is None else f"{value:.0f}ms"


def load(port: int, images: np.ndarray, clients: int, seconds: float,
         requests: Optional[int] = None) -> dict:
    """``clients`` threads each send ``images`` (one request, [n, c, h, w])
    to the daemon on ``port`` over and over for ``seconds``, or until
    ``requests`` requests are answered if that comes first. Returns the
    answered images, the served img/s, the request count and the request
    latencies' p50, p95, p99 (``percentile_ms``: None where the sample is
    too small) and max in ms (host clock, from send to the parsed reply).
    Raises if a client failed or none was answered."""
    latencies: list = []
    counts = [0] * clients
    stop = threading.Event()
    enough = threading.Event()
    lock = threading.Lock()
    errs: list = []
    n = len(images)

    def client(i):
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                out = serve.classify(images, port=port)
                dt = time.perf_counter() - t0
                if len(out) != n:
                    raise RuntimeError(f"{len(out)} results for {n} images")
                with lock:
                    latencies.append(dt)
                    counts[i] += n
                    if requests is not None and len(latencies) >= requests:
                        enough.set()
        except Exception as e:  # reported below, on the caller's thread
            with lock:
                errs.append(e)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    enough.wait(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t_start
    lat = np.sort(np.asarray(latencies)) * 1e3
    if errs or any(t.is_alive() for t in threads) or not len(lat):
        raise RuntimeError(f"soak_serve: client errors {errs[:3]}, "
                           f"{len(lat)} requests answered")
    total = sum(counts)
    pct = {f"p{q}_ms": percentile_ms(lat, q) for q in (50, 95, 99)}
    return {"images": total, "img_per_s": total / wall, "seconds": wall,
            "requests": len(lat), **pct, "max_ms": float(lat[-1])}


def main(argv=None, device=None) -> dict:
    """Run the soak; returns ``load``'s numbers and the daemon's STATS.
    Raises if a client or a batch failed."""
    argv = sys.argv[1:] if argv is None else list(argv)
    name = argv[0] if len(argv) > 0 else "vit_b_16_224"
    batch = int(argv[1]) if len(argv) > 1 else 256
    seconds = float(argv[2]) if len(argv) > 2 else 60.0
    clients = int(argv[3]) if len(argv) > 3 else 4
    quant = argv[4] if len(argv) > 4 else "int8-w8a8"
    if quant in ("none", "bf16"):
        quant = None
    cfg = get_config(name)
    params = fixtures.random_params(cfg, seed=0, scale=0.05)
    engine = InferenceEngine(cfg, params, batch_size=batch,
                             attention_impl="flash", device=device,
                             quantize=quant, normalize_uint8=True)
    warmup_s = engine.warmup()
    srv = serve.InferenceServer(engine, port=0, max_wait_ms=20.0)
    srv.start_background()
    try:
        port = srv.address[1]
        print(f"serving {cfg.name} bs={batch} quant={engine.quantize} on "
              f":{port} ({engine.device}, warmup {warmup_s:.1f}s); soaking "
              f"{seconds:.0f}s x {clients} clients", flush=True)
        # Each client sends batch/clients images per request so the batcher
        # can coalesce the concurrent payloads into full engine batches.
        per_req = max(1, batch // clients)
        rng = np.random.default_rng(0)
        payload_imgs = rng.integers(
            0, 256, (per_req, 3, cfg.img_size, cfg.img_size), np.uint8)
        res = load(port, payload_imgs, clients, seconds)
        s = serve.stats(port=port)
    finally:
        srv.shutdown()
    print(f"soak_serve: {res['images']} images in {res['seconds']:.1f}s = "
          f"{res['img_per_s']:.0f} img/s through the socket; "
          f"{res['requests']} requests, latency p50 {_ms(res['p50_ms'])} "
          f"p95 {_ms(res['p95_ms'])} p99 {_ms(res['p99_ms'])} "
          f"max {res['max_ms']:.0f}ms", flush=True)
    print(f"daemon stats: {s}", flush=True)
    if s["batch_errors"] or s["images_served"] < res["images"]:
        raise RuntimeError(f"soak_serve: {s['batch_errors']} failed batches, "
                           f"{s['images_served']} served of {res['images']} answered")
    return dict(res, stats=s)


if __name__ == "__main__":
    main()

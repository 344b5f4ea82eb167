"""Inference serving: a dynamic-batching TCP daemon on the port's engine.

Counterpart of ``vit_with_opencl_tpu/serve.py``, with the same wire format,
so either package's client talks to either package's server. Clients
stream packed image tensors over a socket; a batcher coalesces concurrent
requests up to the engine's batch size (or a deadline) so the card sees
full batches; results return in the reference's result-line format.

Wire protocol (little-endian):
  request:  uint32 payload_len | payload = the packed image binary
            (4xint32 header (n, c, h, w) + n*c*h*w float32 — io/binfmt —
            or n*c*h*w uint8 raw pixels to a server started with --uint8),
            or the 5 bytes ``STATS``
  response: uint32 payload_len | payload = UTF-8 text, one
            "[i] label: L / prob: P" line per image (Main.c:71 format),
            "ERROR: <msg>" on a bad request, or the STATS counters as JSON.

Batching: requests enqueue individual images; a worker thread drains the
queue into engine-sized batches, waiting at most ``max_wait_ms`` for
stragglers (the reference's host enqueues all images without blocking,
ViT_opencl.c:926-965). The worker calls ``engine.run``: the upload, the
forward on the card (the encoder's CUDA kernels) and one copy back.

    python -m vit_with_opencl_tpu_torch.serve --weights Network \\
        --quantize auto [--uint8] [--dp N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import socketserver
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from . import config as config_lib
from .harness import results
from .io import binfmt

_LEN = struct.Struct("<I")
MAX_PAYLOAD = 1 << 30


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed mid-message")
        got += r
    return bytes(buf)


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_PAYLOAD:
        raise ValueError(f"payload too large: {n}")
    return _recv_exact(sock, n)


class _Request:
    __slots__ = ("image", "event", "label", "prob", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.label: Optional[int] = None
        self.prob: Optional[float] = None
        self.error: Optional[Exception] = None


class Batcher:
    """Coalesces single-image requests into engine-sized batches.

    ``engine.run`` runs on the batcher's own thread. A failure of one batch
    fails that batch's requests and the daemon serves on; a CUDA error that
    poisons the context (an illegal address) fails every later batch as
    well, and only a restart clears it."""

    def __init__(self, engine, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.images_served = 0
        self.batch_errors = 0
        self.started_at = time.time()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        """Observability counters (served over the wire as a STATS request)."""
        return {
            "batches_run": self.batches_run,
            "images_served": self.images_served,
            "batch_errors": self.batch_errors,
            "queue_depth": self.q.qsize(),
            "batch_size": self.engine.batch_size,
            "n_devices": getattr(self.engine, "n_devices", 1),
            "config": self.engine.config.name,
            "uptime_s": round(time.time() - self.started_at, 1),
        }

    def submit_async(self, image: np.ndarray) -> _Request:
        """Enqueue one image; caller waits on the returned request's event.
        Multi-image payloads must enqueue everything before waiting so a
        single connection can fill a whole batch."""
        if self._stop.is_set():
            raise RuntimeError("batcher is shut down")
        req = _Request(image)
        self.q.put(req)
        # Shutdown race: if stop() landed between the check and the put, the
        # drain may have already finished and missed this request — fail it
        # here so no waiter can hang (double event.set is harmless).
        if self._stop.is_set() and not req.event.is_set():
            req.error = RuntimeError("batcher is shut down")
            req.event.set()
        return req

    @staticmethod
    def wait(req: _Request) -> Tuple[int, float]:
        req.event.wait()
        if req.error is not None:
            raise RuntimeError(f"inference failed: {req.error}")
        return req.label, req.prob

    def submit(self, image: np.ndarray) -> Tuple[int, float]:
        return self.wait(self.submit_async(image))

    def _loop(self):
        bs = self.engine.batch_size
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < bs:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                images = np.stack([r.image for r in batch])
                probs = self.engine.run(images)
                preds = results.argmax_predictions(probs)
                # Counted before any waiter wakes: a client that reads STATS
                # as soon as its answer is in sees its batch counted.
                self.batches_run += 1
                self.images_served += len(batch)
                for req, (label, prob) in zip(batch, preds):
                    req.label, req.prob = label, prob
                    req.event.set()
            except Exception as e:
                # Fail this batch's requests; keep serving. One bad batch
                # must not brick the daemon or hang its clients.
                self.batch_errors += 1
                for req in batch:
                    req.error = e
                    req.event.set()
        # Drain: fail anything still queued so no waiter hangs on shutdown.
        shutdown_err = RuntimeError("server shut down")
        while True:
            try:
                req = self.q.get_nowait()
            except queue.Empty:
                break
            req.error = shutdown_err
            req.event.set()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class InferenceServer:
    """TCP server wrapping an ``InferenceEngine`` (or ``DataParallelEngine``)
    behind a Batcher."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 max_wait_ms: float = 5.0):
        self.batcher = Batcher(engine, max_wait_ms)
        self.engine = engine
        batcher = self.batcher
        want_u8 = getattr(engine, "normalize_uint8", False)
        expected = (engine.config.in_chans, engine.config.img_size,
                    engine.config.img_size)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        payload = _recv_msg(self.request)
                    except (ConnectionError, ValueError):
                        return
                    if payload == b"STATS":
                        _send_msg(self.request, json.dumps(batcher.stats()).encode())
                        continue
                    try:
                        images = binfmt.load_image_data_bytes(payload)
                        is_u8 = images.dtype == np.uint8
                        if want_u8 != is_u8:
                            raise ValueError(
                                "payload dtype "
                                f"{'uint8' if is_u8 else 'float32'}"
                                " does not match the server's "
                                f"{'uint8' if want_u8 else 'float32'} mode"
                            )
                        if images.shape[1:] != expected:
                            raise ValueError(
                                f"expected images of shape {expected}, "
                                f"got {images.shape[1:]}"
                            )
                        # Enqueue the whole payload before waiting, so one
                        # connection's n images can fill a batch together.
                        reqs = [batcher.submit_async(images[i])
                                for i in range(images.shape[0])]
                        lines = []
                        for i, req in enumerate(reqs):
                            label, prob = Batcher.wait(req)
                            lines.append(results.format_result_line(i, label, prob))
                        _send_msg(self.request, "\n".join(lines).encode())
                    except Exception as e:  # report, keep the connection
                        _send_msg(self.request, f"ERROR: {e}".encode())

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def serve_forever(self):
        self._server.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self.batcher.stop()


def classify(
    images: np.ndarray, host: str = "127.0.0.1", port: int = 9876
) -> List[Tuple[int, float]]:
    """Client helper: send a [n, c, h, w] batch, return [(label, prob)].

    uint8 arrays go over the wire as raw pixels (4x smaller; requires a
    server started with --uint8); anything else is sent as float32."""
    if images.ndim != 4:
        # The wire header is exactly 4 int32s (n, c, h, w); a CHW array would
        # send a misaligned body the server rejects confusingly.
        raise ValueError(
            f"classify expects a [n, c, h, w] batch, got shape {images.shape}"
        )
    wire = images if images.dtype == np.uint8 else np.asarray(images, "<f4")
    payload = (
        np.asarray(images.shape, "<i4").tobytes()
        + np.ascontiguousarray(wire).tobytes()
    )
    with socket.create_connection((host, port)) as sock:
        _send_msg(sock, payload)
        text = _recv_msg(sock).decode()
    if text.startswith("ERROR:"):
        raise RuntimeError(text)
    out = []
    for line in text.splitlines():
        parsed = results.parse_result_line(line)
        if parsed:
            out.append(parsed)
    return out


def stats(host: str = "127.0.0.1", port: int = 9876) -> dict:
    """Client helper: fetch the daemon's observability counters."""
    with socket.create_connection((host, port)) as sock:
        _send_msg(sock, b"STATS")
        return json.loads(_recv_msg(sock).decode())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--weights", required=True)
    parser.add_argument("--config", default="vit_b_16_224",
                        choices=sorted(config_lib.PRESETS))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9876)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--attention", choices=["xla", "flash", "fused_block"],
                        default="flash",
                        help="plain PyTorch ops, or the CUDA kernels "
                        "(fused_block is a synonym of flash)")
    parser.add_argument("--quantize", choices=["int8", "int8-w8a8", "auto"],
                        default=None)
    parser.add_argument("--calibrate", default=None, metavar="IMAGES.BIN",
                        help="calibration images (packed input binary) for "
                        "outlier-aware W8A8 — the accuracy-defensible "
                        "quantized serving mode; implies w8a8 when "
                        "--quantize is auto/unset")
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--uint8", action="store_true",
                        help="accept raw uint8 pixels and normalize on the "
                        "device (4x less wire and host-to-device traffic)")
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel fan-out: devices to split each "
                        "batch over (0 = every CUDA card; 1 = one device)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cpu runs every kernel's plain PyTorch version")
    args = parser.parse_args(argv)

    import torch

    from .engine import DataParallelEngine, InferenceEngine, resolve_device

    resolve_device(args.device)  # no card and cuda asked for: raise now
    cfg = config_lib.get_config(args.config)
    weights = binfmt.weights_to_dict(
        binfmt.load_weights(args.weights, cfg, strict=True), cfg
    )
    calibrate = None
    if args.calibrate:
        if args.quantize in (None, "auto"):
            args.quantize = "int8-w8a8"
        calibrate = binfmt.load_image_data(args.calibrate)
        print(f"calibration set: {calibrate.shape[0]} images "
              f"({args.calibrate})")

    n_dp = torch.cuda.device_count() if args.dp == 0 else args.dp
    if n_dp < 1:
        raise SystemExit(f"--dp {args.dp}: no device to serve on")
    if n_dp > 1:
        devices = ([f"cuda:{i}" for i in range(n_dp)] if args.device == "cuda"
                   else ["cpu"] * n_dp)
        engine = DataParallelEngine(
            cfg, weights, batch_size=args.batch_size, devices=devices,
            attention_impl=args.attention, quantize=args.quantize,
            normalize_uint8=args.uint8, calibrate=calibrate,
        )
    else:
        engine = InferenceEngine(
            cfg, weights, batch_size=args.batch_size,
            attention_impl=args.attention, device=args.device,
            quantize=args.quantize, normalize_uint8=args.uint8,
            calibrate=calibrate,
        )
    # On this thread, before the server starts: the kernels are built and
    # loaded before any request, not in the batcher under a client's wait.
    warmup_s = engine.warmup()
    server = InferenceServer(engine, args.host, args.port,
                             max_wait_ms=args.max_wait_ms)
    print(f"serving {cfg.name} on {server.address} (batch={args.batch_size}, "
          f"dp={n_dp}, quantize={engine.quantize}, device={engine.device}, "
          f"warmup {warmup_s:.1f}s)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

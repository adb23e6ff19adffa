"""HTTP load bench of the port: concurrent clients against its endpoint.

The counterpart of ``tools/http_bench.py`` for ``cyclegan_tpu_torch``, in
torch alone (no JAX). It starts ``cyclegan_tpu_torch.http_serve.
make_server`` in this process on an artifact of the port (``--export``),
fires ``--clients`` threads x ``--requests`` POST /predict each (a real PNG
body at the artifact's load size), and prints one JSON line: ``clients``,
``requests_per_client``, ``max_batch``, ``format``, ``device``,
``req_per_s``, ``latency_ms`` percentiles (p50, p90, p99, max),
``mean_batch`` (images a device call, from the server's micro-batcher),
``device_calls`` and ``warmup_calls`` (the server's warm-up forwards, one
a micro-batch bucket).

Run: python tools/torch_http_bench.py ARTIFACT [--clients 8] [--requests 24]
     [--max_batch 8] [--format mask] [--device cuda|cpu]

The device is the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions; for tests).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cyclegan_tpu_torch.http_serve import make_server  # noqa: E402


def percentile(sorted_s: list[float], q: float) -> float:
    """The ``q`` quantile of sorted seconds, in ms (the JAX tool's index)."""
    n = len(sorted_s)
    return sorted_s[min(n - 1, int(n * q))] * 1e3


def bench(artifact: str, *, clients: int = 8, requests: int = 24, max_batch: int = 8,
          fmt: str = "mask", device: str = "cuda") -> dict:
    """Serve ``artifact`` in a thread, load it, and return the JSON record."""
    from PIL import Image

    server = make_server(artifact, port=0, max_batch=max_batch, device=device)
    host, port = server.server_address
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        h, w = server.info["load_hw"]
        ch = server.info["in_channels"]
        body = io.BytesIO()
        pixels = np.random.RandomState(0).randint(0, 255, (h, w, ch), np.uint8)
        Image.fromarray(pixels.squeeze(-1) if ch == 1 else pixels).save(body, format="PNG")
        payload = body.getvalue()
        lat: list[float] = []
        lock = threading.Lock()
        errors: list = []

        def client() -> None:
            conn = HTTPConnection(host, port, timeout=300)
            try:
                for _ in range(requests):
                    t0 = time.perf_counter()
                    conn.request("POST", f"/predict?format={fmt}", payload,
                                 {"Content-Type": "image/png"})
                    r = conn.getresponse()
                    data = r.read()
                    dt = time.perf_counter() - t0
                    if r.status != 200:
                        errors.append((r.status, data[:120]))
                        return
                    with lock:
                        lat.append(dt)
            finally:
                conn.close()

        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        elapsed = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    if errors:
        raise RuntimeError(f"request failures: {errors[:3]}")
    lat.sort()
    m = server.metrics
    return {"clients": clients, "requests_per_client": requests, "max_batch": max_batch,
            "format": fmt, "device": str(server.info["device"]),
            "req_per_s": len(lat) / elapsed,
            "latency_ms": {"p50": percentile(lat, 0.5), "p90": percentile(lat, 0.9),
                           "p99": percentile(lat, 0.99), "max": lat[-1] * 1e3},
            "mean_batch": m.batched_images_sum / max(m.device_call_count, 1),
            "device_calls": m.device_call_count,
            "warmup_calls": len(server.batcher.buckets())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24, help="requests per client")
    ap.add_argument("--max_batch", type=int, default=8,
                    help="server-side micro-batching cap (1 disables)")
    ap.add_argument("--format", default="mask", choices=["png", "mask", "json"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a card) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.artifact, clients=args.clients, requests=args.requests,
                           max_batch=args.max_batch, fmt=args.format, device=args.device)))


if __name__ == "__main__":
    main()

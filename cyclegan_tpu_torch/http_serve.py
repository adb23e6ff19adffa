"""HTTP inference endpoint over an exported artifact.

Counterpart of ``cyclegan_tpu/http_serve.py``:
``python -m cyclegan_tpu_torch.main --serve model.pt --serve_http PORT``
starts a stdlib HTTP server that answers segmentation requests on the card.

Endpoints:

- ``GET /healthz``: ``{"status": "ok", "requests": N}``.
- ``GET /info``: manifest, window and load shapes, class count, device,
  batch cap, and ``tta``: the canvas, flip, scales and data-parallel
  options the server was built with.
- ``GET /metrics``: Prometheus text (request counters, latency histogram).
- ``POST /predict[?format=png|mask|json]``: the body is an encoded image;
  ``png`` (default) answers the VOC-palette prediction, ``mask`` the raw
  class indices as a grayscale PNG, ``json`` the per-class pixel counts.

Device work runs one call at a time with adaptive micro-batching
(``--serve_http_batch``, default 8): requests that arrive while a call is in
flight are coalesced by the next leader into one batch, zero-padded to a
power-of-two bucket. Every bucket is run once at start-up, so the kernels
are built and warm before the first request.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from cyclegan_tpu_torch.data.palette import save_prediction_png
from cyclegan_tpu_torch.data.transforms import eval_transform
from cyclegan_tpu_torch.serve import build_predictor

MAX_BODY_BYTES = 64 * 1024 * 1024  # reject absurd uploads before decode

# Predict-latency histogram bucket upper bounds (seconds).
_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Metrics:
    """Request counters + predict-latency histogram in the Prometheus text
    format (the JAX endpoint's metric names, so dashboards carry over)."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.requests_total: dict[str, int] = {}  # by (route, code)
        self.predict_seconds_sum = 0.0
        self.predict_seconds_count = 0
        self.bucket_counts = [0] * len(_LATENCY_BUCKETS)
        self.device_call_seconds_sum = 0.0
        self.device_call_count = 0
        self.batched_images_sum = 0

    def count(self, route: str, code: int) -> None:
        key = f'route="{route}",code="{code}"'
        with self.lock:
            self.requests_total[key] = self.requests_total.get(key, 0) + 1

    def observe_predict(self, seconds: float) -> None:
        """Per-request latency: queue wait + the device rounds it took."""
        with self.lock:
            self.predict_seconds_sum += seconds
            self.predict_seconds_count += 1
            for i, ub in enumerate(_LATENCY_BUCKETS):
                if seconds <= ub:
                    self.bucket_counts[i] += 1  # render() sums cumulatively
                    break

    def observe_device_call(self, seconds: float, n_images: int) -> None:
        with self.lock:
            self.device_call_seconds_sum += seconds
            self.device_call_count += 1
            self.batched_images_sum += n_images

    def render(self) -> str:
        with self.lock:
            lines = ["# HELP cyclegan_tpu_requests_total HTTP requests by route and "
                     "status code",
                     "# TYPE cyclegan_tpu_requests_total counter"]
            for key, n in sorted(self.requests_total.items()):
                lines.append(f"cyclegan_tpu_requests_total{{{key}}} {n}")
            lines += ["# HELP cyclegan_tpu_predict_seconds Per-request predict latency: "
                      "queue wait + device round(s); count == requests",
                      "# TYPE cyclegan_tpu_predict_seconds histogram"]
            cum = 0
            for ub, n in zip(_LATENCY_BUCKETS, self.bucket_counts):
                cum += n
                lines.append(f'cyclegan_tpu_predict_seconds_bucket{{le="{ub}"}} {cum}')
            lines += [
                f'cyclegan_tpu_predict_seconds_bucket{{le="+Inf"}} '
                f"{self.predict_seconds_count}",
                f"cyclegan_tpu_predict_seconds_sum {self.predict_seconds_sum}",
                f"cyclegan_tpu_predict_seconds_count {self.predict_seconds_count}",
                "# HELP cyclegan_tpu_device_call_seconds Device call latency totals "
                "(one coalesced batch per call, fetch included)",
                "# TYPE cyclegan_tpu_device_call_seconds summary",
                f"cyclegan_tpu_device_call_seconds_sum {self.device_call_seconds_sum}",
                f"cyclegan_tpu_device_call_seconds_count {self.device_call_count}",
                "# HELP cyclegan_tpu_predict_images_total Images served by device calls",
                "# TYPE cyclegan_tpu_predict_images_total counter",
                f"cyclegan_tpu_predict_images_total {self.batched_images_sum}",
            ]
        return "\n".join(lines) + "\n"


class _Slot:
    """One queued request: input image, completion event, result or error."""

    __slots__ = ("img", "done", "out", "err")

    def __init__(self, img: np.ndarray) -> None:
        self.img = img
        self.done = threading.Event()
        self.out: np.ndarray | None = None
        self.err: BaseException | None = None


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped: the batch shapes the device sees."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class _MicroBatcher:
    """Adaptive request coalescing over one batched predictor.

    Leader-follower: every request enqueues its slot, then competes for
    leadership. The leader drains up to ``max_batch`` slots, zero-pads the
    stack to a power-of-two bucket, runs ONE device call, fetches it and
    completes the slots; followers wait on a condition. No timers: batches
    form only when requests overlap, so a lone client pays batch-1 latency.
    """

    def __init__(self, predict, max_batch: int, metrics: _Metrics) -> None:
        self.predict = predict
        self.max_batch = max(1, int(max_batch))
        self.metrics = metrics
        self._cond = threading.Condition(threading.Lock())  # queue + leadership
        self._leader_active = False
        self._queue: list[_Slot] = []

    def buckets(self) -> list[int]:
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        out.append(self.max_batch)
        return out

    def _serve_round(self) -> None:
        """As leader: drain one batch and complete its slots."""
        with self._cond:
            take = self._queue[:self.max_batch]
            del self._queue[:len(take)]
        if not take:
            return
        try:
            batch = np.stack([s.img for s in take])
            b = _bucket(batch.shape[0], self.max_batch)
            if b > batch.shape[0]:
                pad = np.zeros((b - batch.shape[0],) + batch.shape[1:], batch.dtype)
                batch = np.concatenate([batch, pad])
            t0 = time.perf_counter()
            pred = self.predict(batch).cpu().numpy()
            self.metrics.observe_device_call(time.perf_counter() - t0, len(take))
            for s, p in zip(take, pred):
                s.out = p.astype(np.uint8)
        except BaseException as e:  # deliver to every waiter, then re-raise
            for s in take:
                s.err = e
            if not isinstance(e, Exception):
                raise
        finally:
            for s in take:
                s.done.set()

    def predict_one(self, img: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        slot = _Slot(img)
        with self._cond:
            self._queue.append(slot)
        while True:
            with self._cond:
                while not slot.done.is_set() and self._leader_active:
                    self._cond.wait()
                if slot.done.is_set():
                    break
                self._leader_active = True
            try:
                self._serve_round()
            finally:
                with self._cond:
                    self._leader_active = False
                    self._cond.notify_all()
        if slot.err is not None:
            # A fresh exception per request: the round's exception object is
            # shared by every coalesced waiter.
            raise RuntimeError(f"device call failed: {slot.err}") from slot.err
        self.metrics.observe_predict(time.perf_counter() - t0)
        return slot.out


def _decode_image(data: bytes, hw: tuple[int, int], in_channels: int,
                  eval_resize: str, input_dtype: str = "float32") -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im.convert("L" if in_channels == 1 else "RGB"))
    if arr.ndim == 2:
        arr = arr[..., None]
    img, _ = eval_transform(arr, None, crop_hw=hw, mode=eval_resize,
                            normalize_img=input_dtype != "uint8")
    return img


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _pred_png_bytes(pred: np.ndarray) -> bytes:
    buf = io.BytesIO()
    save_prediction_png(pred, buf)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    # The server object carries info, batcher and metrics (see make_server).
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet unless verbose: /healthz polls
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str, route: str | None = None) -> None:
        # Count before writing: a client that scrapes /metrics right after
        # its reply must see its request.
        self.server.metrics.count(route or urlparse(self.path).path, code)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj, route: str | None = None) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json", route=route)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"status": "ok", "requests": self.server.requests_served})
            return
        if path == "/metrics":
            self._reply(200, self.server.metrics.render().encode(),
                        "text/plain; version=0.0.4")
            return
        if path == "/info":
            info = self.server.info
            self._json(200, {
                "manifest": info["manifest"], "head": info["head"],
                "num_classes": info["num_classes"],
                "window_hw": list(info["window_hw"]), "load_hw": list(info["load_hw"]),
                "in_channels": info["in_channels"], "eval_resize": info["eval_resize"],
                "input_dtype": info["input_dtype"], "device": info["device"],
                "max_batch": self.server.batcher.max_batch,
                "tta": self.server.tta_options,
            })
            return
        self._json(404, {"error": f"unknown path {path!r} (GET /healthz, /info, "
                                  f"/metrics; POST /predict)"}, route="unknown")

    def do_POST(self):  # noqa: N802 (http.server API)
        url = urlparse(self.path)
        if url.path != "/predict":
            self._json(404, {"error": f"unknown path {url.path!r} (POST /predict)"},
                       route="unknown")
            return
        fmt = parse_qs(url.query).get("format", ["png"])[0]
        if fmt not in ("png", "mask", "json"):
            self._json(400, {"error": f"format must be png|mask|json, got {fmt!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0:
            self._json(400, {"error": "empty body (send encoded image bytes with "
                                      "Content-Length)"})
            return
        if length > MAX_BODY_BYTES:
            self._json(413, {"error": f"body {length} bytes exceeds {MAX_BODY_BYTES}"})
            return
        data = self.rfile.read(length)
        info = self.server.info
        try:
            img = _decode_image(data, info["load_hw"], info["in_channels"],
                                info["eval_resize"], info["input_dtype"])
        except Exception as e:  # PIL raises a zoo of decode errors
            self._json(400, {"error": f"could not decode image: {e}"})
            return
        try:
            pred = self.server.batcher.predict_one(img)
        except Exception as e:  # a failed device call fails this request
            self._json(500, {"error": f"predict failed: {e}"})
            return
        with self.server.count_lock:
            self.server.requests_served += 1
        if fmt == "png":
            self._reply(200, _pred_png_bytes(pred), "image/png")
        elif fmt == "mask":
            self._reply(200, _png_bytes(pred), "image/png")
        else:
            idx, cnt = np.unique(pred, return_counts=True)
            resp = {"shape": list(pred.shape),
                    "class_pixels": {int(i): int(n) for i, n in zip(idx, cnt)}}
            names = info["manifest"].get("class_names") or []
            if len(names) == info["num_classes"] and len(set(names)) == len(names):
                resp["class_pixels_named"] = {
                    names[int(i)]: int(n) for i, n in zip(idx, cnt)
                    if 0 <= int(i) < len(names)}
            self._json(200, resp)


def make_server(artifact_path: str, *, host: str = "127.0.0.1", port: int = 0,
                eval_resize: str = "resize", canvas_hw: tuple[int, int] | None = None,
                flip: bool = False, scales: tuple[float, ...] | None = None,
                warmup: bool = True, max_batch: int = 8, data_parallel: bool = False,
                device=None, verbose: bool = False) -> ThreadingHTTPServer:
    """Build (and warm up) the HTTP server on ``device`` (default CUDA).

    ``port=0`` binds an ephemeral port (``server.server_address[1]``).
    ``canvas_hw``, ``flip``, ``scales`` and ``data_parallel`` are
    ``serve.build_predictor``'s (tiled serving, TTA, one replica per card);
    ``/info`` reports them under ``tta``. ``warmup`` runs one zero batch per
    micro-batch bucket at the load size, which also builds the kernels.
    Call ``serve_forever()`` on the result (or :func:`run_http_serve`).
    """
    predict, info = build_predictor(artifact_path, eval_resize=eval_resize, device=device,
                                    canvas_hw=canvas_hw, data_parallel=data_parallel,
                                    flip=flip, scales=scales)
    if info["num_classes"] > 255:
        raise ValueError(f"--serve_http supports at most 255 classes (artifact has "
                         f"{info['num_classes']}): the PNG responses are 8-bit")
    server = ThreadingHTTPServer((host, port), _Handler)
    server.info = info
    server.count_lock = threading.Lock()
    server.requests_served = 0
    server.metrics = _Metrics()
    server.batcher = _MicroBatcher(predict, max_batch, server.metrics)
    server.verbose = verbose
    server.tta_options = {"flip": bool(flip), "scales": list(scales) if scales else None,
                          "canvas_hw": list(canvas_hw) if canvas_hw else None,
                          "data_parallel": bool(data_parallel),
                          "max_batch": server.batcher.max_batch}
    if warmup:
        h, w = info["load_hw"]
        for b in server.batcher.buckets():
            predict(np.zeros((b, h, w, info["in_channels"]),
                             np.dtype(info["input_dtype"]))).cpu()
    return server


def run_http_serve(artifact_path: str, *, host: str = "127.0.0.1", port: int = 8000,
                   **opts) -> None:
    """CLI entry: serve until interrupted."""
    server = make_server(artifact_path, host=host, port=port, **opts)
    bound = server.server_address
    print(f"serving {artifact_path} on http://{bound[0]}:{bound[1]} "
          f"(GET /healthz, /info, /metrics; POST /predict)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()

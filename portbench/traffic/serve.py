"""Serving traffic: the tiled, flipped, multi-scale predictor, batch after batch.

Set-up makes G_i2l's weights from the seed, writes them as the port's
float32-weight artifact (``export.export_generator``, the logits head, the
configuration's compute type) under ``TMPDIR``, and builds
``serve.build_predictor(artifact, canvas_hw, flip, scales)``. Inputs are a
ring of ``params['ring']`` distinct canvases made from the seed, held on
the host as float32 arrays, ``images_per_call`` consecutive ones a call.
Calls go back to back with one batch in flight ahead, as ``run_serve``'s
pipeline keeps them: submit batch k + 1, then fetch batch k's uint8 class
maps to the host.

Window (``--trace 0``): ``serve_img_per_s`` is the images whose class maps
reached the host over the window's whole time. Traced run: ``host_probes``
calls each from an idle device, host-timed, then as many again with the
program's spans recorded (the span probes), then ``trace_batches`` batches
under the profiler, spans recorded. The window records none. The check: a
sample of the answers (``check_answers``, drawn from the seed among all the
run fetched) against the reference.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import compare, inputs, readings
from portbench import spans as S
from portbench import trace as T
from portbench.reference import precise
from portbench.reference.precision import EXACT
from portbench.reference.serve import ReferenceServer, served_gap
from portbench.traffic.train import free, sync
from portbench.work import calls, model


def make_inputs(ctx):
    """(G_i2l's weights, the ring of canvases on the device) of the seed."""
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    weights = inputs.make_weights(ctx.cfg, gen, ("G_i2l",))["G_i2l"]
    return weights, inputs.make_images(ctx.params, ctx.cfg["in_channels"], gen)


class Program:
    """The predictor and its feed; :meth:`submit` enqueues the next batch,
    :meth:`fetch` brings a batch's class maps to the host."""

    def __init__(self, ctx, quantize: str | None = None):
        """``quantize``: the artifact's weight-only quantisation (the
        port's own lower-precision path; None, as served, for the runs)."""
        from cyclegan_tpu_torch.export import export_generator
        from cyclegan_tpu_torch.kernels import _build
        from cyclegan_tpu_torch.models.generators import define_Gen
        from cyclegan_tpu_torch.serve import build_predictor

        cfg, p, dev = ctx.cfg, ctx.params, ctx.device
        if dev.type == "cuda":
            _build.build_all()
        ctx.mark("kernels built")
        weights, images = make_inputs(ctx)
        per = p["images_per_call"]
        if len(images) % per:
            raise ValueError(f"a ring of {len(images)} canvases is no whole number of "
                             f"batches of {per}")
        host = images.cpu().numpy()
        self.batches = [np.ascontiguousarray(host[i:i + per])
                        for i in range(0, len(host), per)]
        ctx.mark("inputs")
        module = define_Gen(cfg["in_channels"], cfg["num_classes"], cfg["ngf"], cfg["gen_net"],
                            norm=cfg["norm"], head="none")
        inputs.load_into(module, {k: v.cpu() for k, v in weights.items()}, "G_i2l")
        tmp = tempfile.mkdtemp(prefix="portbench-")
        try:
            path = export_generator(
                module, os.path.join(tmp, "g_i2l"), gen_net=cfg["gen_net"], ngf=cfg["ngf"],
                num_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
                crop_hw=(cfg["crop_height"], cfg["crop_width"]),
                dtype="bfloat16" if cfg["bf16"] else "float32", head="logits",
                dataset=cfg["dataset"], quantize=quantize)
            self.predict, _ = build_predictor(path, device=dev, canvas_hw=tuple(p["canvas_hw"]),
                                              flip=p["flip"], scales=tuple(p["scales"]))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ctx.mark("artifact and predictor")
        self.per_call = p["images_per_call"]
        self.calls = 0
        self.answers = []  # (canvas index, uint8 class map)

    def submit(self):
        k = self.calls % len(self.batches)
        self.calls += 1
        return range(k * self.per_call, (k + 1) * self.per_call), self.predict(self.batches[k])

    def fetch(self, pending) -> int:
        idx, out = pending
        maps = out.cpu().numpy()
        self.answers.extend(zip(idx, maps))
        return len(idx)

    def pipelined(self, batches: int | None = None, deadline: float | None = None) -> tuple:
        """Calls with one batch in flight ahead, for ``batches`` calls or
        until ``deadline``; returns (images submitted, images fetched)."""
        sent = got = 0
        pending = None
        while (batches is None or sent < batches * self.per_call) and \
                (deadline is None or time.perf_counter() < deadline):
            nxt = self.submit()
            sent += len(nxt[0])
            if pending is not None:
                got += self.fetch(pending)
            pending = nxt
        if pending is not None:
            got += self.fetch(pending)
        return sent, got


def probes(prog: Program, n: int, dev) -> tuple[list, int, int]:
    """``n`` calls each from an idle device: the host ms until each call
    returns, and the images sent and fetched."""
    host = []
    sent = got = 0
    for _ in range(n):
        sync(dev)
        t = time.perf_counter()
        pending = prog.submit()
        host.append((time.perf_counter() - t) * 1e3)
        sent += len(pending[0])
        got += prog.fetch(pending)
    return host, sent, got


def traced(prog: Program, ctx) -> tuple[readings.Observation, int, int]:
    from cyclegan_tpu_torch.kernels import _build

    dev, p = ctx.device, ctx.params
    host, sent, got = probes(prog, p["host_probes"], dev)
    with S.recorded() as take:
        _, s, g = probes(prog, p["host_probes"], dev)
        sent, got = sent + s, got + g
        sync(dev)
        probe_spans = take()
        before = dict(_build.launches)
        with torch.profiler.profile(activities=T.activities(dev)) as prof:
            s0 = time.time_ns()
            s, g = prog.pipelined(batches=p["trace_batches"])
            sync(dev)
            s1 = time.time_ns()
        spans = take()
    launched = {k: v - before.get(k, 0) for k, v in _build.launches.items()}
    cfg = ctx.cfg
    obs = readings.Observation(
        trace=T.from_profiler(prof, s0, s1), units=p["trace_batches"], launches=launched,
        calls=calls.serve_batch_calls(cfg, p), model_flops=model.serve_batch_flops(cfg, p),
        host_ms=host, spans=spans, span_calls=S.from_profiler(prof, s0, s1),
        probe_spans=probe_spans)
    return obs, sent + s, got + g


def reference_logits(ctx, canvases: list, q=EXACT) -> dict:
    """{canvas index: (H, W, K) float32 served logits} by the reference in
    precision ``q``."""
    weights, images = make_inputs(ctx)
    cfg, p = ctx.cfg, ctx.params
    with precise():
        ref = ReferenceServer(weights, cfg, (cfg["crop_height"], cfg["crop_width"]),
                              flip=p["flip"], scales=tuple(p["scales"]), q=q)
        return {i: ref.logits(images[i]) for i in sorted(set(canvases))}


def sample(answers: list, ctx) -> list:
    """The answers the check compares, drawn from the seed."""
    rng = np.random.default_rng([ctx.seed, 1])
    k = min(ctx.params["check_answers"], len(answers))
    return [answers[i] for i in sorted(rng.choice(len(answers), size=k, replace=False))]


def numbers(answers: list, logits: dict) -> dict:
    dev = next(iter(logits.values())).device
    return {"served_gap": max(served_gap(logits[i], torch.from_numpy(m).to(dev))
                              for i, m in answers)}


def run(ctx) -> dict:
    prog = Program(ctx)
    for _ in range(ctx.params["warm_batches"]):
        prog.fetch(prog.submit())
    prog.answers.clear()
    ctx.mark("warm batches")
    ctx.window_open()
    out = {}
    if ctx.trace:
        out["obs"], sent, got = traced(prog, ctx)
    else:
        t0 = time.perf_counter()
        sent, got = prog.pipelined(deadline=t0 + ctx.seconds)
        out["e2e"] = {"serve_img_per_s": got / (time.perf_counter() - t0)}
    out["attempted"], out["failed"] = sent, sent - got
    dev = ctx.device
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answers = sample(prog.answers, ctx)
    del prog
    free(dev)
    ctx.mark("window")
    nums = numbers(answers, reference_logits(ctx, [i for i, _ in answers]))
    out["correct"], out["checks"] = compare.verdict(nums, ctx.limits)
    return out

"""The port's spans (``utils/observability.py``) on the CPU, and one case on
the card.

- Off by default: a train step and a predictor record nothing, and
  ``span`` hands out one shared null context.
- On: ``train_step``, ``multi_step`` and ``accum_step`` record their
  phases under ``train_step`` roots, in order, one unit id a step; a tiled,
  flipped, 3-scale predictor records ``serve.predict`` > ``serve.scale`` x3
  > ``serve.flip`` > ``serve.tiles`` x2 > ``serve.forward``.
- Spans share the profiler's clock: every operator Adam issues lies inside
  ``g_update`` / ``d_update``.
- Each thread keeps its own stack; ``StepProfiler``'s window annotates the
  operator's trace with the spans.
- ``tools/torch_span_trace.py`` on a train and the serve cell at a CPU
  size: each probe's self times add up to its root, whose duration is the
  probe's host time.
- On the card (``cuda``): the backward's launches, made on the autograd
  engine's thread, are attributed by time to ``g_backward``.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import export, serve
from cyclegan_tpu_torch.models.generators import define_Gen
from cyclegan_tpu_torch.train.cyclegan import CycleGANTrainer
from cyclegan_tpu_torch.utils import observability as obs
from cyclegan_tpu_torch.utils.config import Config

PHASES = ["g_forward", "g_backward", "g_update", "pool", "d_forward", "d_backward", "d_update"]
ACCUM_PHASES = (["g_forward", "g_backward"] * 2 + ["g_update", "pool", "pool"]
                + ["d_forward", "d_backward"] * 2 + ["d_update"])
K = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def recording():
    obs.take_spans()
    obs.record_spans(True)
    try:
        yield
    finally:
        obs.record_spans(False)


def _batch(rng, rows=2, size=32, device="cpu"):
    b = {"lab_image": rng.uniform(-1, 1, (rows, size, size, 3)).astype(np.float32),
         "unlab_image": rng.uniform(-1, 1, (rows, size, size, 3)).astype(np.float32),
         "lab_label": rng.integers(0, 5, (rows, size, size))}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _trainer(device="cpu"):
    cfg = Config(gen_net="resnet_2blocks", ngf=8, ndf=8, crop_height=32, crop_width=32,
                 bf16=False, pool_size=2, batch_size=2)
    t = CycleGANTrainer(cfg, 5, 3, steps_per_epoch=10, device=device)
    return t, t.init_state(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def trainer():
    return _trainer()


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    G = define_Gen(3, 5, 8, "resnet_2blocks", head="none",
                   generator=torch.Generator().manual_seed(0))
    path = export.export_generator(G, str(tmp_path_factory.mktemp("tracing") / "g"),
                                   gen_net="resnet_2blocks", ngf=8, num_classes=5,
                                   in_channels=3, crop_hw=(32, 32), dtype="float32",
                                   head="logits", dataset="synthetic")
    return {"tiled": serve.build_predictor(path, device="cpu", canvas_hw=(64, 64), flip=True,
                                           scales=(0.75, 1.0, 1.25))[0],
            "untiled": serve.build_predictor(path, device="cpu")[0]}


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


def _nested(spans):
    """Every span closed, inside its parent's interval, on its thread."""
    for s in spans:
        assert s.end is not None and s.start <= s.end
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end and p.thread == s.thread


def test_spans_are_off_by_default(trainer, predictor):
    t, st = trainer
    assert obs.span("g_forward") is obs.span("serve.predict", unit=3)
    t.train_step(st, _batch(np.random.default_rng(0)))
    predictor["tiled"](np.zeros((1, 64, 64, 3), np.float32))
    assert obs.take_spans() == []


@pytest.mark.parametrize("call", ["train_step", "multi_step", "accum_step"])
def test_train_step_records_its_phases_in_order(trainer, call):
    t, st = trainer
    rng = np.random.default_rng(1)
    if call == "train_step":
        batch, roots, phases = _batch(rng), 1, PHASES
    else:
        micro = [_batch(rng) for _ in range(K)]
        batch = {k: torch.stack([b[k] for b in micro]) for k in micro[0]}
        roots, phases = (K, PHASES) if call == "multi_step" else (1, ACCUM_PHASES)
    first = st.step
    with recording():
        getattr(t, call)(st, batch)
    spans = obs.take_spans()
    _nested(spans)
    top = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in top] == ["train_step"] * roots
    assert [spans[i].unit for i in top] == list(range(first, first + roots))
    for i in top:
        assert _children(spans, i) == phases
        assert {s.unit for s in spans if s.parent == i} == {spans[i].unit}
    assert len(spans) == roots * (1 + len(phases))  # no other span
    assert obs.take_spans() == []


@pytest.mark.parametrize("which", ["tiled", "untiled"])
def test_predictor_records_its_stages(predictor, which):
    canvas = 64 if which == "tiled" else 32
    images = np.random.default_rng(2).uniform(-1, 1, (2, canvas, canvas, 3)).astype(np.float32)
    with recording():
        for _ in range(2):
            predictor[which](images)
    spans = obs.take_spans()
    _nested(spans)
    top = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in top] == ["serve.predict"] * 2
    assert spans[top[1]].unit == spans[top[0]].unit + 1
    for s in spans:
        root = s
        while root.parent >= 0:
            root = spans[root.parent]
        assert s.unit == root.unit
    if which == "untiled":
        assert [_children(spans, i) for i in top] == [["serve.forward"]] * 2
        return
    below = {"serve.predict": ["serve.scale"] * 3, "serve.scale": ["serve.flip"],
             "serve.flip": ["serve.tiles"] * 2, "serve.tiles": ["serve.forward"],
             "serve.forward": []}
    for i, s in enumerate(spans):
        assert _children(spans, i) == below[s.name], s.name
    assert len(spans) == 2 * (1 + 3 + 3 + 6 + 6)


def test_adam_ops_lie_inside_the_update_spans(trainer):
    """Spans and the profiler's operator events share one clock."""
    t, st = trainer
    with recording(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.train_step(st, _batch(np.random.default_rng(3)))
    spans = obs.take_spans()
    updates = [(s.start, s.end) for s in spans if s.name in ("g_update", "d_update")]
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    steps = [(a, b) for n, a, b in events if n.startswith("Optimizer.step#Adam")]
    assert len(steps) == 2 and len(updates) == 2
    adam_ops = [(a, b) for n, a, b in events if n.startswith("aten::")
                and any(sa <= a and b <= sb for sa, sb in steps)]
    assert adam_ops
    for a, b in steps + adam_ops:
        assert any(ua <= a and b <= ub for ua, ub in updates), (a, b, updates)


def test_each_thread_keeps_its_own_stack():
    both = threading.Barrier(2, timeout=30)

    def work(name):
        with obs.span(name, unit=7 if name == "a" else 8):
            both.wait()
            with obs.span(name + ".child"):
                both.wait()

    with recording():
        threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    spans = obs.take_spans()
    _nested(spans)
    assert sorted((s.name, spans[s.parent].name if s.parent >= 0 else None, s.unit)
                  for s in spans) == [("a", None, 7), ("a.child", "a", 7),
                                      ("b", None, 8), ("b.child", "b", 8)]


def test_step_profiler_window_annotates_the_spans(tmp_path):
    trace_dir = tmp_path / "trace"
    prof = obs.StepProfiler(str(trace_dir), start=0, stop=1)
    prof.maybe_start(0)
    with obs.span("g_forward"):
        torch.ones(4).sum()
    prof.maybe_stop(1)
    (trace,) = os.listdir(trace_dir)
    assert '"g_forward"' in (trace_dir / trace).read_text()
    assert obs.span("g_forward") is obs.span("d_forward")  # off again outside the window
    assert obs.take_spans() == []


@pytest.mark.parametrize("cell", ["voc_dp8_bf16.train", "voc_semisup_256.serve_tta"])
def test_span_trace_tool_on_a_tiny_cell(cell):
    from portbench.tests import tiny
    from tools import torch_span_trace

    out = torch_span_trace.run(cell, 2 ** 31 + 7, "cpu", tiny.overrides(cell))
    c = out["checks"]
    assert c["probe_self_sum_worst_ns"] == 0
    assert 0.9 < c["root_over_host"] <= 1.01, c
    if cell.endswith(".train"):
        host = [k for k in out["metrics"] if k.endswith("_host_ms.train")]
        assert len(host) == 4 and all(out["metrics"][k] > 0 for k in host)
        assert out["units"] == 2 and out["spans"] == 2 * 8
    else:
        assert out["metrics"] == {"serve_front.tta_device_share": None}  # no device here
        assert out["units"] == 2


@pytest.mark.cuda
def test_backward_launches_on_the_engine_thread_go_to_g_backward():
    """On the card the autograd engine runs the backward on its device
    thread (a gradient hook sees another thread than the span's); the
    launches it makes are attributed by time to ``g_backward``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the autograd engine's device thread")
    from portbench import spans as S

    t, st = _trainer("cuda")
    batch = _batch(np.random.default_rng(4), device="cuda")
    t.train_step(st, batch)  # warm
    torch.cuda.synchronize()
    engine = set()
    hook = next(t.G_i2l.parameters()).register_hook(
        lambda g: engine.add(threading.get_ident()))
    try:
        with recording(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            s0 = time.time_ns()
            t.train_step(st, batch)
            torch.cuda.synchronize()
            s1 = time.time_ns()
    finally:
        hook.remove()
    spans = obs.take_spans()
    (g_backward,) = [i for i, s in enumerate(spans) if s.name == "g_backward"]
    assert engine and spans[g_backward].thread not in engine
    calls = S.from_profiler(prof, s0, s1)
    idx = S.Index(spans)
    launched = [c for c in calls.host if c.name in S.LAUNCHES
                and idx.innermost(c.start) == g_backward]
    assert len(launched) > 100
    assert S.device_ns(spans, calls)[g_backward] > 0
    assert S.rooted_share(spans, calls, "train_step") >= 99.0

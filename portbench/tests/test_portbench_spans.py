"""The span readers (``portbench/spans.py``) on synthetic spans and calls:
attribution by time across threads, self time, launch and sync counting,
the serving front's device share, idle gaps by span, and None where there
is nothing to read."""

import collections
import time

import pytest
import torch

from portbench import spans as S

MS = 1_000_000  # ns
# The fields of cyclegan_tpu_torch.utils.observability.Span.
Span = collections.namedtuple("Span", "name start end parent unit thread")


def _step(t0, unit, first=0, thread=1):
    """A train_step at ``t0`` ms: 2 ms of root self time, then its seven
    phases of 1, 2, ..., 7 ms; ``first`` is the root's index in the list."""
    out = [Span("train_step", t0 * MS, (t0 + 30) * MS, -1, unit, thread)]
    at = t0 + 2
    for k, name in enumerate(["g_forward", "g_backward", "g_update", "pool", "d_forward",
                              "d_backward", "d_update"], 1):
        out.append(Span(name, at * MS, (at + k) * MS, first, unit, thread))
        at += k
    return out


def _calls(host, device, t1=100):
    return S.Calls(0, t1 * MS, [S.Call(n, a * MS, (a + 0.01) * MS, c) for n, a, c in host],
                   [S.Call(n, a * MS, b * MS, c) for n, a, b, c in device])


def test_device_work_goes_to_the_span_that_launched_it_by_time_not_thread():
    spans = _step(0, 0)   # g_backward [3, 5) ms, g_update [5, 8) ms on thread 1
    # The spans are thread 1's; the calls at 3.5 and 4.5 ms come from the
    # autograd engine's thread (a trace gives calls no usable thread).
    calls = _calls([("cudaLaunchKernel", 2.5, 1),     # g_forward
                    ("cudaLaunchKernel", 3.5, 2),     # g_backward
                    ("cudaLaunchKernel", 4.5, 3),
                    ("cudaLaunchKernel", 6.0, 4)],    # g_update
                   [("k1", 3, 4, 1), ("k2", 4, 6, 2), ("k3", 6, 7, 3), ("adam", 7, 10, 4)])
    by_name = {spans[i].name: ns for i, ns in S.device_ns(spans, calls).items()}
    assert by_name == {"g_forward": 1 * MS, "g_backward": 3 * MS, "g_update": 3 * MS}
    assert S.update_device_ms(spans, calls) == pytest.approx(3.0)
    assert S.rooted_share(spans, calls, "train_step") == pytest.approx(100.0)
    late = _calls([("cudaLaunchKernel", 40, 5)], [("k", 40, 41, 5)])
    assert S.rooted_share(spans, late, "train_step") == 0.0  # launched outside every root


def test_self_time_and_host_ms_median_over_roots():
    spans = _step(0, 0) + _step(40, 1, first=8)
    own = S.self_ns(spans)
    assert own[0] == 2 * MS and own[8] == 2 * MS  # the roots' time outside their phases
    assert [own[i] for i in range(1, 8)] == [k * MS for k in range(1, 8)]
    spans[9] = spans[9]._replace(end=spans[9].end + MS // 2)  # step 2's g_forward 0.5 ms longer
    spans[8] = spans[8]._replace(end=spans[8].end + MS // 2)
    assert S.host_ms(spans, {"g_forward", "d_forward"}) == pytest.approx((1 + 5 + 1 + 5.5) / 2)
    assert S.host_ms(spans, {"pool"}) == pytest.approx(4.0)
    # Phase self times and the root's add up to the root's duration.
    own = S.self_ns(spans)
    for r in (0, 8):
        assert sum(own[i] for i, s in enumerate(spans) if i == r or s.parent == r) == \
            spans[r].end - spans[r].start


def test_launches_and_host_syncs_a_step():
    spans = _step(0, 0) + _step(40, 1, first=8)
    host = [("cudaLaunchKernel", 3, 1), ("cudaLaunchKernelExC", 4, 2),
            ("cudaLaunchCooperativeKernel", 5, 3), ("cudaMemsetAsync", 6, 4),
            ("cudaMemcpyAsync", 7, 5),                # to the host: a sync too
            ("cudaStreamSynchronize", 7.5, 6),
            ("cudaMemcpyAsync", 42, 7),               # to the device: a launch only
            ("cudaLaunchKernel", 35, 8),              # between the steps
            ("cudaEventRecord", 43, 9)]               # neither
    device = [("k", 3, 4, 1), ("Memcpy DtoH (Device -> Pageable)", 7, 7.1, 5),
              ("Memcpy HtoD (Pinned -> Device)", 42, 42.1, 7)]
    calls = _calls(host, device)
    assert S.launches(spans, calls) == (5 + 1) / 2
    assert S.host_syncs(spans, calls) == 2 / 2


def test_serving_front_share_and_idle_by_span():
    spans = [Span("serve.predict", 0, 20 * MS, -1, 0, 1),
             Span("serve.tiles", 1 * MS, 15 * MS, 0, 0, 1),
             Span("serve.forward", 2 * MS, 10 * MS, 1, 0, 1)]
    calls = _calls([("cudaMemcpyAsync", 0.5, 1), ("cudaLaunchKernel", 3, 2),
                    ("cudaLaunchKernel", 12, 3), ("cudaLaunchKernel", 25, 4)],
                   [("copy", 1, 2, 1), ("conv", 4, 10, 2), ("stitch", 12, 15, 3),
                    ("after", 25, 26, 4)], t1=30)
    assert S.tta_device_share(spans, calls) == pytest.approx(100 * (1 + 3) / (1 + 6 + 3))
    by = S.by_span(spans, calls)
    assert by["serve.forward"] == pytest.approx([6.0, 2.0])   # idle [2, 4) began in it
    assert by["serve.tiles"] == pytest.approx([3.0, 2.0])     # idle [10, 12)
    # Idle [0, 1) and [15, 25): the latter began in serve.predict, so it is
    # serve.predict's though the call returned at 20.
    assert by["serve.predict"] == pytest.approx([1.0, 1.0 + 10.0])
    assert by[S.NO_SPAN] == pytest.approx([1.0, 4.0])         # idle [26, 30)


def test_readers_find_nothing_without_spans_or_device_work():
    calls = _calls([("cudaLaunchKernel", 1, 1)], [("k", 1, 2, 1)])
    for read in (S.update_device_ms, S.launches, S.host_syncs, S.tta_device_share):
        assert read([], calls) is None
    assert S.host_ms([], {"pool"}) is None
    assert S.update_device_ms(_step(0, 0), _calls([], [])) is None
    assert S.rooted_share(_step(0, 0), _calls([], []), "train_step") is None
    # A CPU profile has host operators and no device work.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s0 = time.time_ns()
        torch.ones(64).sum()
        s1 = time.time_ns()
    cpu = S.from_profiler(prof, s0, s1)
    assert cpu.device == [] and any(c.name.startswith("aten::") for c in cpu.host)
    assert all(c.end > s0 and c.start < s1 for c in cpu.host)
    assert S.launches(_step(0, 0), cpu) is None


# The readers of an Observation, on a recorded CPU run of the tiny cells.

def _traced(cell):
    """A ``--trace 1`` run's Observation on the CPU (the traffic kind's
    own ``run``), and the spans left behind after it."""
    import importlib

    from cyclegan_tpu_torch.utils import observability as O

    from portbench import harness
    from portbench.tests import tiny

    torch.set_num_threads(4)
    c = harness.load_cell(cell)
    ctx = harness.make_context(c, 2 ** 31 + 31, 0.3, True, torch.device("cpu"),
                               time.perf_counter(), tiny.overrides(cell))
    out = importlib.import_module(f"portbench.traffic.{c.workload['kind']}").run(ctx)
    return out["obs"], ctx.params, O.take_spans()


def _at(spans, name):
    """A time (ns) inside the first span named ``name``."""
    s = next(s for s in spans if s.name == name)
    return (s.start + s.end) // 2


@pytest.mark.parametrize("cell", ["voc_dp8_bf16.train", "voc_dp8_bf16.train_dropout"])
def test_trainer_readers_on_a_recorded_run(cell):
    obs, p, left = _traced(cell)
    assert left == []  # recording off again, nothing left behind
    assert len(S.roots(list(obs.probe_spans), "train_step")) == p["host_probes"]
    assert len(S.roots(list(obs.spans), "train_step")) == p["trace_steps"]
    phases = [S.read_fwd_host_ms(obs), S.read_bwd_host_ms(obs), S.read_update_host_ms(obs),
              S.read_pool_host_ms(obs)]
    assert all(v > 0 for v in phases)
    # the phases' self times fit in a probe's step
    steps = sorted((s.end - s.start) / MS for s in obs.probe_spans if s.name == "train_step")
    assert sum(phases) <= steps[-1]
    # a CPU profile holds no device work: nothing to read
    assert obs.span_calls is not None and obs.span_calls.device == []
    for read in (S.read_update_device_ms, S.read_launches, S.read_host_syncs):
        assert read(obs) is None
    # the recorded spans against device work placed in them: 1 ms launched
    # in each step's g_update, 2 ms in its g_backward, one copy to the host
    # in the first step
    stretch = list(obs.spans)
    host, device = [], []
    for k, step in enumerate(s for s in stretch if s.name == "train_step"):
        mine = [s for s in stretch if s.start >= step.start and s.end <= step.end]
        for j, (name, ms) in enumerate((("g_update", 1), ("g_backward", 2))):
            t = _at(mine, name)
            host.append(S.Call("cudaLaunchKernel", t, t + 1000, 10 * k + j))
            device.append(S.Call("k", t, t + ms * MS, 10 * k + j))
    t = _at(stretch, "pool")
    host.append(S.Call("cudaMemcpyAsync", t, t + 1000, 99))
    device.append(S.Call("Memcpy DtoH (Device -> Pageable)", t, t + 1000, 99))
    obs.span_calls = S.Calls(stretch[0].start, max(s.end for s in stretch), host, device)
    assert S.read_update_device_ms(obs) == pytest.approx(1.0)
    assert S.read_launches(obs) == pytest.approx(2 + 1 / p["trace_steps"])
    assert S.read_host_syncs(obs) == pytest.approx(1 / p["trace_steps"])
    assert S.read_tta_device_share(obs) is None


def test_serving_front_reader_on_a_recorded_run():
    obs, p, left = _traced("voc_semisup_256.serve_tta")
    assert left == []
    stretch = list(obs.spans)
    assert len(S.roots(stretch, "serve.predict")) == p["trace_batches"]
    assert len(S.roots(list(obs.probe_spans), "serve.predict")) == p["host_probes"]
    assert {"serve.scale", "serve.flip", "serve.tiles", "serve.forward"} <= \
        {s.name for s in stretch}
    assert S.read_tta_device_share(obs) is None  # no device work on the CPU
    # 3 ms launched in a forward, 1 ms as a predict call opens
    fwd, scale = _at(stretch, "serve.forward"), stretch[0].start
    idx = S.Index(stretch)
    assert "serve.forward" not in idx.names(idx.innermost(scale))
    obs.span_calls = S.Calls(stretch[0].start, max(s.end for s in stretch),
                             [S.Call("cudaLaunchKernel", fwd, fwd + 1000, 1),
                              S.Call("cudaLaunchKernel", scale, scale + 1000, 2)],
                             [S.Call("conv", fwd, fwd + 3 * MS, 1),
                              S.Call("resize", scale, scale + MS, 2)])
    assert S.read_tta_device_share(obs) == pytest.approx(25.0)
    for read in (S.read_launches, S.read_host_syncs, S.read_update_device_ms):
        assert read(obs) is None  # no train step in a served stretch


@pytest.mark.parametrize("cell", ["voc_dp8_bf16.train", "voc_semisup_256.serve_tta"])
def test_no_span_is_recorded_without_trace(cell, monkeypatch):
    """The ``--trace 0`` run leaves span recording off throughout."""
    from cyclegan_tpu_torch.utils import observability as O

    from portbench import harness
    from portbench.tests import tiny

    turned = []
    record = O.record_spans
    monkeypatch.setattr(O, "record_spans", lambda on: (turned.append(on), record(on)))
    torch.set_num_threads(4)
    r = harness.run_cell(cell, 2 ** 31 + 32, 0.3, False, device="cpu",
                         overrides=tiny.overrides(cell))
    assert r["correct"] and turned == [] and O.take_spans() == []

"""The layout of the chunked block's normalisation kernels, on the CPU.

``kernels/resblock_chunked.py::chunk_plan`` decides how
``csrc/resblock_chunked.cu`` lays one call out on the card: a thread-block
cluster per (sample, 32 channels), its CTAs taking the sample's row chunks
in order, each holding its tiles in shared memory where they fit. The C
entry checks the plan it is given and the card tests run it
(``tests/test_torch_cuda.py``); these tests hold the plan itself and what
the wrappers pass to C, without a card.
"""

import inspect

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.kernels import _build
from cyclegan_tpu_torch.kernels import resblock_chunked as RC

# (which, vjp) of the four calls: IN1 and IN2 forward, IN2 and IN1 VJP.
CALLS = [(1, False), (2, False), (2, True), (1, True)]


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("which,vjp", CALLS)
def test_chunk_plan_at_the_train_shape(which, vjp, elt):
    """The trunk's (b, 64, 64, 256) at hc 8: clusters of 8 CTAs, one chunk
    each, 8 channel groups, 128 CTAs at batch 2 (of 132 SMs) and 64 at
    batch 1; every tile held in shared memory (two partials a channel for
    each of the 8 chunks, and 512 pixels x 32 channels of each input)."""
    plan = RC.chunk_plan(64, 64, 256, 8, RC.in_bytes(which, vjp, elt))
    assert (plan.chunks, plan.cluster, plan.per_cta, plan.groups) == (8, 8, 1, 8)
    assert [plan.cluster * plan.groups * n for n in (2, 1)] == [128, 64]
    tile_bytes = {(1, False): 4, (2, False): 4 + elt, (2, True): 2 * elt,
                  (1, True): 4 + elt}[(which, vjp)]
    assert plan.resident and plan.smem == 8 * 2 * 32 * 4 + 512 * 32 * tile_bytes
    assert plan.smem <= RC.CHUNK_SMEM_MAX


@pytest.mark.parametrize("h,w,hc", [(64, 64, 8), (64, 64, 1), (12, 9, 12), (16, 16, 4),
                                    (8, 8, 1), (26, 6, 2), (52, 3, 4), (8, 320, 8)])
def test_chunk_plan_covers_every_pixel_once_in_chunk_order(h, w, hc):
    """The CTAs of one (sample, channel group) cluster take each pixel of
    the sample exactly once, each its whole chunks in chunk order (rank r
    from chunk r * per_cta); the cluster is the largest count up to 8 that
    divides the chunks."""
    plan = RC.chunk_plan(h, w, 32, hc, 4)
    k = h // hc
    assert plan.chunks == k and plan.cluster * plan.per_cta == k
    assert plan.cluster == max(d for d in range(1, RC.CHUNK_CLUSTER_MAX + 1) if k % d == 0)
    chunk_px = hc * w
    seen = np.zeros(h * w, int)
    order = []
    for rank in range(plan.cluster):
        first = rank * plan.per_cta
        order += list(range(first, first + plan.per_cta))
        seen[first * chunk_px:(first + plan.per_cta) * chunk_px] += 1
    assert order == list(range(k)) and (seen == 1).all()


@pytest.mark.parametrize("shape,in_bytes,resident", [((8, 320, 32, 8), 4, False),
                                                     ((8, 320, 32, 8), 2, True),
                                                     ((64, 256, 64, 8), 6, False),
                                                     ((64, 64, 256, 1), 6, True)])
def test_chunk_plan_holds_tiles_only_where_they_fit(shape, in_bytes, resident):
    """A CTA's shared memory stays within CHUNK_SMEM_MAX: its tiles where
    they fit, else only the partials (the kernel then reads its inputs
    from memory, and again from L2 to apply)."""
    h, w, c, hc = shape
    plan = RC.chunk_plan(h, w, c, hc, in_bytes)
    part = plan.chunks * 2 * RC.CHUNK_GROUP * 4
    tiles = plan.per_cta * hc * w * RC.CHUNK_GROUP * in_bytes
    assert plan.resident == resident == (part + tiles <= RC.CHUNK_SMEM_MAX)
    assert plan.smem == (part + tiles if resident else part) <= RC.CHUNK_SMEM_MAX


def test_chunk_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="C % 32"):
        RC.chunk_plan(16, 16, 48, 4, 4)
    with pytest.raises(ValueError, match="H % hc"):
        RC.chunk_plan(12, 8, 32, 8, 4)
    assert "n" not in inspect.signature(RC.chunk_plan).parameters


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which,vjp", CALLS)
def test_chunked_norm_wrappers_pass_the_plan_and_no_scratch(monkeypatch, which, vjp, dtype):
    """What in_fwd and in_vjp hand the C entry: the tensors, the shape, hc
    and the plan, in the order of its signature; no scratch is asked for
    (the partials stay in the clusters' shared memory)."""
    calls = []
    monkeypatch.setattr(_build, "call", lambda lib, fn, *args: calls.append((fn, args)))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)

    def no_scratch(*_):
        raise AssertionError("the chunked norm kernels take no scratch")

    monkeypatch.setattr(_build, "scratch_ptr", no_scratch)
    n, h, w, c, hc = 2, 16, 12, 64, 4
    x = torch.zeros((n, h, w, c), dtype=dtype)
    f32 = torch.zeros((n, h, w, c))
    stats = torch.zeros((n, 4, c))
    if vjp:
        g = f32 if which == 1 else x
        RC.in_vjp(g, x, stats, f32.clone(), hc, which, dv=x.clone(), a=x.clone())
    else:
        RC.in_fwd(f32, stats, x, x.clone(), x.clone(), hc, 1e-5, which)
    (fn, args), = calls
    assert fn == ("cg_chunked_in_vjp" if vjp else "cg_chunked_in_fwd")
    assert len(args) == len(_build.SIGNATURES["resblock_chunked"][fn])
    plan = RC.chunk_plan(h, w, c, hc, RC.in_bytes(which, vjp, x.element_size()))
    ptrs = 6 if vjp else 5
    assert args[ptrs:ptrs + 8] == (n, h, w, c, hc, plan.cluster, plan.per_cta,
                                   int(plan.resident))
    assert args[-3:-1] == (which, _build.DTYPE_CODES[dtype])

"""The tile plan of the direct-conv kernel K4 (`kernel_ops.conv_direct_plan`,
which `kernel_ops.conv_direct` hands to `csrc/conv_direct.cu`), at every
geometry the port launches K4 at: reference_cnn's two forwards and conv2's
input gradient (K4'), conv-bench's five rows, a ragged stride-2 forward
with one-sided pads, a forward whose O is off the 16-byte grid, and every
preset's conv forwards and input gradients as its training step makes
them (recorded from a CPU step through the kernel backend), at the
training batch (32) and the eval batch (2048).

At each, in float32 and bf16, the plan must:
- cover every output (pixel, channel) exactly once, and launch no block
  wholly outside the output;
- stay within the grid limits and 227 KB of shared memory;
- take the 16-byte copies exactly where C (and, without the flip, O) is a
  multiple of a 16-byte chunk, and refuse a misaligned operand there.

CPU only: the plan is plain Python, the kernel itself is held to its plain
version on the card by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch.bench.conv_shapes import SHAPES
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import MODEL_PRESETS, get_model
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

SMEM_LIMIT = 227 * 1024            # a block's shared memory on the H100
GRID_X_MAX, GRID_Y_MAX = 2 ** 31 - 1, 65535
ALIGNED = 0x7F0000000100           # a 256-byte aligned device address
ITEMSIZES = {"float32": 4, "bfloat16": 2}
BATCHES = (32, 2048)               # training batch, eval batch


def _geom(n, h, w, c, o, k, stride, pads, dil=1, flip=False) -> dict:
    return dict(n=n, h=h, w=w, c=c, o=o, k=k, stride=stride,
                pads=tuple(pads), dil=dil, flip=flip)


FIXED = {
    "reference_cnn conv1": _geom(32, 28, 28, 1, 16, 3, 2, (1, 1, 1, 1)),
    "reference_cnn conv2": _geom(32, 14, 14, 16, 32, 3, 2, (1, 1, 1, 1)),
    "reference_cnn conv2 K4'": _geom(
        32, 7, 7, 32, 16, 3, 1,
        kernel_ops.conv_input_grad_pads(14, 14, 3, 3, 2, 1, 7, 7), 2, True),
    **{f"conv-bench {n}x{h}x{w}x{c}->{o} s{s}": _geom(n, h, w, c, o, k, s,
                                                       (p, p, p, p))
       for (n, h, w, c, k, o, s, p) in SHAPES},
    "ragged stride-2": _geom(8, 15, 15, 24, 40, 3, 2, (1, 0, 1, 0)),
    # C on the 16-byte grid but O off it, so the weight rows [k][o] are
    # not: the whole tile takes the element-wise gather
    "O off the 16-byte grid": _geom(8, 10, 10, 16, 6, 5, 1, (2, 2, 2, 2)),
}


def _check_plan(g: dict, itemsize: int) -> kernel_ops.ConvPlan:
    n, c, o, k = g["n"], g["c"], g["o"], g["k"]
    oh, ow = kernel_ops.conv_out_hw(g["h"], g["w"], k, k, g["stride"],
                                    g["pads"], g["dil"])
    assert oh >= 1 and ow >= 1
    plan = kernel_ops.conv_direct_plan(n, oh, ow, c, o, k, k, flip=g["flip"],
                                       itemsize=itemsize, x_ptr=ALIGNED,
                                       w_ptr=ALIGNED)
    m = n * oh * ow
    assert plan.bm == 128
    assert plan.bn in ((16, 32, 64, 128) if itemsize == 2 else (16, 32, 64))
    # every output exactly once: the tiles are a product of row ranges and
    # channel ranges, each of which must cover its axis once
    for extent, tile, blocks in ((m, plan.bm, plan.grid_m),
                                 (o, plan.bn, plan.grid_n)):
        cover = np.zeros(extent, np.int64)
        for b in range(blocks):
            assert b * tile < extent, "a block wholly outside the output"
            cover[b * tile:(b + 1) * tile] += 1
        assert (cover == 1).all()
    assert 1 <= plan.grid_m <= GRID_X_MAX and 1 <= plan.grid_n <= GRID_Y_MAX
    assert m <= 2 ** 31 - 1 - plan.bm     # the kernel's 32-bit row index
    assert 0 < plan.smem_bytes <= SMEM_LIMIT
    chunk = 16 // itemsize
    allowed = c % chunk == 0 and (g["flip"] or o % chunk == 0)
    assert plan.vec == allowed
    # a misaligned x or w: refused where the geometry takes the 16-byte
    # copies, the element-wise gather where it does not
    for x_ptr, w_ptr in ((ALIGNED + itemsize, ALIGNED),
                         (ALIGNED, ALIGNED + 8)):
        kwargs = dict(flip=g["flip"], itemsize=itemsize, x_ptr=x_ptr,
                      w_ptr=w_ptr)
        if allowed:
            with pytest.raises(ValueError, match="16-byte aligned"):
                kernel_ops.conv_direct_plan(n, oh, ow, c, o, k, k, **kwargs)
        else:
            assert kernel_ops.conv_direct_plan(n, oh, ow, c, o, k, k,
                                               **kwargs) == plan
    return plan


@pytest.mark.parametrize("dtype", sorted(ITEMSIZES))
@pytest.mark.parametrize("name", sorted(FIXED))
def test_plan_at_fixed_geometries(name, dtype):
    _check_plan(FIXED[name], ITEMSIZES[dtype])


def _preset_launches(preset: str) -> list[dict]:
    """The K4 geometries of one training step of `preset` on the kernel
    backend (batch 2; the batch only scales the rows), recorded from the
    plain version the CPU wrapper calls."""
    calls = []
    plain = kernel_ops.conv_direct_plain

    def record(x, w, *, stride, pads, dil, flip):
        n, h, wd, c = x.shape
        o = w.shape[2] if flip else w.shape[3]
        calls.append(_geom(n, h, wd, c, o, w.shape[0], stride, pads, dil,
                           flip))
        assert w.shape[0] == w.shape[1]
        return plain(x, w, stride=stride, pads=pads, dil=dil, flip=flip)

    model = get_model(preset)
    params = model.init(prng.key(0),
                        get_initializer("normal"))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.rand(2, *model.input_shape)
    kernel_ops.conv_direct_plain = record
    try:
        loss = model.apply(params, x, backend="cuda").square().mean()
        torch.autograd.grad(loss, leaves)
    finally:
        kernel_ops.conv_direct_plain = plain
    return calls


@pytest.mark.parametrize("preset", sorted(MODEL_PRESETS))
def test_plan_at_every_preset_launch(preset):
    calls = _preset_launches(preset)
    forwards = [g for g in calls if not g["flip"]]
    grads = [g for g in calls if g["flip"]]
    # each conv once forward; each but the image's conv once backward
    assert forwards and len(grads) == len(forwards) - 1
    for g in calls:
        for batch in BATCHES:
            for itemsize in ITEMSIZES.values():
                _check_plan({**g, "n": batch}, itemsize)


def test_wrapper_refuses_a_misaligned_view():
    """The CUDA path of conv_direct plans before it launches: a bf16 x
    whose data starts 2 bytes into its storage (a contiguous view at an
    offset) with C = 64 raises instead of taking the 16-byte copies or the
    element-wise gather; the same x, aligned, passes the plan and stops
    only at the device check (these tensors lie on the CPU)."""
    g = FIXED["conv-bench 128x32x32x64->64 s1"]
    shape = (2, g["h"], g["w"], g["c"])
    w = torch.zeros(3, 3, g["c"], g["o"], dtype=torch.bfloat16)
    base = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    misaligned = base[1:1 + int(np.prod(shape))].view(shape)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    kw = dict(stride=1, pads=(1, 1, 1, 1), dil=1, flip=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel_ops._conv_direct_cuda(misaligned, w, **kw)
    aligned = base[:int(np.prod(shape))].view(shape)
    if aligned.data_ptr() % 16 == 0:
        with pytest.raises(ValueError, match="CUDA device"):
            kernel_ops._conv_direct_cuda(aligned, w, **kw)
    # on the CPU the public wrapper takes the plain version, aligned or not
    torch.testing.assert_close(
        kernel_ops.conv_direct(misaligned, w, **kw),
        kernel_ops.conv_direct_plain(misaligned.clone(), w, **kw))

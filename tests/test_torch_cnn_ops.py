"""The port's CNN ops and data pipeline (`mpi_cuda_cnn_tpu_torch/ops`,
`/data`) against the JAX package on the CPU, with inputs made by numpy
from a seed and handed to both.

Host-side data (synthetic stripes, IDX files, normalization, one-hot,
the epoch order) is bitwise the reference's. Float results are held to
`max|got - want| <= tol * max|want|` with tol stated per test: both
sides compute in float32, in other summation orders (XLA's and
PyTorch's CPU convolutions and matmuls; the TPU kernel's window sums in
Pallas interpret mode), so a sum of K products differs by a few ulp of
its largest terms. The CUDA kernels run only on the card; here their
wrappers take the plain versions (the launch counts stay 0), and
`chip_smoke.py` holds each kernel to its plain version on an H100.
"""

import gzip
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data import datasets as jds
from mpi_cuda_cnn_tpu.data import idx as jidx
from mpi_cuda_cnn_tpu.data import pipeline as jpipe
from mpi_cuda_cnn_tpu.ops import activations as jact
from mpi_cuda_cnn_tpu.ops import conv as jconv
from mpi_cuda_cnn_tpu.ops.dense import dense as jax_dense
from mpi_cuda_cnn_tpu.ops import losses as jloss
from mpi_cuda_cnn_tpu.ops.pallas_ops import conv2d_pallas, dense_pallas
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu_torch.data import datasets, idx, pipeline
from mpi_cuda_cnn_tpu_torch.ops import _kernels, activations, conv, losses
from mpi_cuda_cnn_tpu_torch.ops import dense as tdense
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# Forward sums of up to 1,568 float32 products, and their gradients:
# a few ulp of the largest term, relative to the output's magnitude.
TOL = 1e-5
# (n, h, w, cin, kh, cout, stride, padding): tests/test_pallas.py's
# CONV_CASES — reference_cnn's two convs, a k5 p2 case and an odd one.
CONV_CASES = [
    (4, 28, 28, 1, 3, 16, 2, 1),
    (4, 14, 14, 16, 3, 32, 2, 1),
    (2, 8, 8, 3, 5, 4, 1, 2),
    (2, 6, 6, 2, 3, 3, 1, 0),
]
DENSE_CASES = [(32, 1568, 200), (5, 7, 3), (32, 200, 10)]


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= tol * scale, f"max abs err {err} > {tol} x {scale}"


@pytest.fixture
def no_launch():
    """Asserts that the test launched no CUDA kernel (CPU tensors take
    the plain versions)."""
    before = dict(_kernels.launches)
    yield
    assert _kernels.launches == before


# ---------------------------------------------------------------------------
# Data: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_train=64, num_test=16),
    dict(num_train=10, num_test=3, height=32, width=32, channels=3, seed=7),
])
def test_synthetic_stripes_bitwise(kw):
    a, b = datasets.synthetic_stripes(**kw), jds.synthetic_stripes(**kw)
    for f in ("train_images", "train_labels", "test_images", "test_labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    assert a.input_shape == b.input_shape and a.num_classes == b.num_classes


@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32])
def test_idx_round_trip_across_packages(tmp_path, suffix, dtype):
    arr = (np.random.default_rng(0).integers(0, 255, (5, 4, 3))
           .astype(dtype))
    idx.write_idx(tmp_path / f"a{suffix}", arr)
    jidx.write_idx(tmp_path / f"b{suffix}", arr)
    assert ((tmp_path / f"a{suffix}").read_bytes() if not suffix else
            gzip.decompress((tmp_path / f"a{suffix}").read_bytes())) == \
        ((tmp_path / f"b{suffix}").read_bytes() if not suffix else
         gzip.decompress((tmp_path / f"b{suffix}").read_bytes()))
    got = idx.read_idx(tmp_path / f"b{suffix}")
    np.testing.assert_array_equal(got, jidx.read_idx(tmp_path / f"a{suffix}"))
    assert got.dtype == arr.dtype


def test_idx_errors_and_synthetic_sentinel(tmp_path):
    (tmp_path / "bad").write_bytes(b"\x01\x00\x08\x01")
    with pytest.raises(idx.IdxError, match="magic"):
        idx.read_idx(tmp_path / "bad")
    paths = datasets.write_synthetic_idx(
        tmp_path, datasets.synthetic_stripes(num_train=8, num_test=4))
    ds = datasets.load_idx_dataset("idx", *paths.values())
    np.testing.assert_array_equal(ds.train_images,
                                  jds.load_idx_dataset("idx", *paths.values())
                                  .train_images)
    (tmp_path / "SYNTHETIC-DATA").touch()
    with pytest.raises(idx.IdxError, match="SYNTHETIC-DATA"):
        datasets.load_idx_dataset("idx", *paths.values())


def test_pipeline_bitwise():
    imgs = np.random.default_rng(1).integers(0, 256, (6, 5, 4), np.uint8)
    labels = np.array([3, 0, 9, 9, 1, 2])
    np.testing.assert_array_equal(pipeline.normalize_images(imgs),
                                  jpipe.normalize_images(imgs))
    assert pipeline.normalize_images(imgs).shape == (6, 5, 4, 1)
    np.testing.assert_array_equal(pipeline.one_hot(labels, 10),
                                  jpipe.one_hot(labels, 10))
    np.testing.assert_array_equal(pipeline.ensure_channel_axis(imgs),
                                  jpipe.ensure_channel_axis(imgs))
    assert pipeline.PIXEL_SCALE == jpipe.PIXEL_SCALE


@pytest.mark.parametrize("seed,n", [(0, 256), (3, 60_000)])
def test_epoch_order_bitwise(seed, n):
    stub = SimpleNamespace(cfg=SimpleNamespace(seed=seed), num_train=n)
    for epoch in (0, 1, 7):
        np.testing.assert_array_equal(Trainer._epoch_order(stub, epoch),
                                      JaxTrainer._epoch_order(stub, epoch))


def test_registry_and_pick_eval_batch():
    assert set(datasets._REGISTRY) == set(jds._REGISTRY)
    with pytest.raises(KeyError):
        datasets.get_dataset("nope")
    for n, g in ((10_000, 1), (64, 1), (100, 8), (3, 4)):
        assert (Trainer._pick_eval_batch(n, g)
                == JaxTrainer._pick_eval_batch(n, g))


# ---------------------------------------------------------------------------
# Activations and losses
# ---------------------------------------------------------------------------


def test_activations_and_softmax():
    x = _rand(4, 10) * 3
    x[0, 0] = 0.0
    for name in ("relu", "tanh", "linear", None):
        _assert_close(activations.ACTIVATIONS[name](torch.from_numpy(x)),
                      jact.ACTIVATIONS[name](jnp.asarray(x)), 1e-6)
    big = np.array([[1e4, 1e4 - 1.0, 0.0]], np.float32)
    p = activations.stable_softmax(torch.from_numpy(big))
    assert torch.isfinite(p).all()
    _assert_close(p, jact.stable_softmax(jnp.asarray(big)), 1e-6)
    _assert_close(activations.stable_softmax(torch.from_numpy(x)),
                  jact.stable_softmax(jnp.asarray(x)), 1e-6)


def test_losses_and_ce_gradient():
    rng = np.random.default_rng(3)
    logits = _rand(8, 10, seed=3) * 4
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    tl = torch.from_numpy(logits).requires_grad_(True)
    loss = losses.softmax_cross_entropy(tl, torch.from_numpy(y))
    _assert_close(loss, jloss.softmax_cross_entropy(jnp.asarray(logits),
                                                    jnp.asarray(y)), 1e-6)
    (grad,) = torch.autograd.grad(loss, tl)
    want = jax.grad(lambda l: jloss.softmax_cross_entropy(l, jnp.asarray(y)))(
        jnp.asarray(logits))
    _assert_close(grad, want, 1e-6)
    probs = activations.stable_softmax(torch.from_numpy(logits))
    got = losses.squared_error_total(probs, torch.from_numpy(y))
    _assert_close(got, jloss.squared_error_total(
        jact.stable_softmax(jnp.asarray(logits)), jnp.asarray(y)), 1e-6)
    # etotal is the reference's sum of squared residuals over the batch
    # divided by the batch size.
    d = probs.numpy() - y
    np.testing.assert_allclose(got.item(), (d * d).sum() / 8, rtol=1e-6)


# ---------------------------------------------------------------------------
# Dense: torch backend, and the K3 wrappers' plain versions
# ---------------------------------------------------------------------------


def _dense_grads(fn, x, w, b):
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = fn(*xs)
    grads = torch.autograd.grad((y ** 2).sum(), xs)
    return y, grads


def _jax_dense_grads(fn, x, w, b):
    args = [jnp.asarray(a) for a in (x, w, b)]
    y = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(*args)
    return y, grads


@pytest.mark.parametrize("m,k,n", DENSE_CASES)
def test_dense_forward_and_backward(m, k, n, no_launch):
    x, w, b = _rand(m, k), _rand(k, n, seed=1) / np.float32(k ** 0.5), _rand(n, seed=2)
    want_y, want_g = _jax_dense_grads(jax_dense, x, w, b)
    pal_y, pal_g = _jax_dense_grads(dense_pallas, x, w, b)
    for fn in (tdense.dense, kernel_ops.dense_kernel):
        y, grads = _dense_grads(fn, x, w, b)
        _assert_close(y, want_y)
        _assert_close(y, pal_y)
        for g, wg, pg in zip(grads, want_g, pal_g):
            _assert_close(g, wg)
            _assert_close(g, pg)


@pytest.mark.parametrize("trans_a", [False, True])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_gemm_plain_transposes_in_place(trans_a, trans_b, bias, no_launch):
    m, k, n = 7, 45, 33
    a = _rand(k, m) if trans_a else _rand(m, k)
    b = _rand(n, k, seed=1) if trans_b else _rand(k, n, seed=1)
    bb = _rand(n, seed=2) if bias else None
    want = (a.T if trans_a else a) @ (b.T if trans_b else b)
    if bias:
        want = want + bb
    got = kernel_ops.gemm(torch.from_numpy(a), torch.from_numpy(b),
                          trans_a=trans_a, trans_b=trans_b,
                          bias=None if bb is None else torch.from_numpy(bb))
    _assert_close(got, want)


# ---------------------------------------------------------------------------
# Conv: torch backend, named gradient ops, and the K4/K5 plain versions
# ---------------------------------------------------------------------------


def _conv_inputs(n, h, w, cin, k, cout):
    return _rand(n, h, w, cin), _rand(k, k, cin, cout, seed=1)


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride,pad", CONV_CASES)
def test_conv_forward_and_backward(n, h, w, cin, k, cout, stride, pad,
                                   no_launch):
    x, wk = _conv_inputs(n, h, w, cin, k, cout)
    jx, jw = jnp.asarray(x), jnp.asarray(wk)

    def jloss_of(fn):
        return lambda a, b: jnp.sum(fn(a, b) ** 2)

    xla = lambda a, b: jconv.conv2d(a, b, stride=stride, padding=pad)  # noqa: E731
    pal = lambda a, b: conv2d_pallas(a, b, stride, pad)  # noqa: E731
    wants = [(xla(jx, jw), jax.grad(jloss_of(xla), argnums=(0, 1))(jx, jw)),
             (pal(jx, jw), jax.grad(jloss_of(pal), argnums=(0, 1))(jx, jw))]
    ports = [lambda a, b: conv.conv2d(a, b, stride=stride, padding=pad),
             lambda a, b: kernel_ops.conv2d_kernel(a, b, stride, pad)]
    for fn in ports:
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(wk).requires_grad_(True)
        y = fn(tx, tw)
        grads = torch.autograd.grad((y ** 2).sum(), (tx, tw))
        for want_y, want_g in wants:
            _assert_close(y, want_y)
            _assert_close(grads[0], want_g[0])
            _assert_close(grads[1], want_g[1])


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride,pad", CONV_CASES)
def test_named_conv_gradients(n, h, w, cin, k, cout, stride, pad, no_launch):
    """conv2d_input_grad / conv2d_kernel_grad against the JAX package's,
    and the K4 (transposed conv) and K5 plain versions against both."""
    x, wk = _conv_inputs(n, h, w, cin, k, cout)
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    g = _rand(n, oh, ow, cout, seed=2)
    want_dx = jconv.conv2d_input_grad(jnp.asarray(g), jnp.asarray(wk),
                                      stride=stride, padding=pad,
                                      input_hw=(h, w))
    want_dw = jconv.conv2d_kernel_grad(jnp.asarray(x), jnp.asarray(g),
                                       stride=stride, padding=pad)
    tg, tw, tx = map(torch.from_numpy, (g, wk, x))
    _assert_close(conv.conv2d_input_grad(tg, tw, stride=stride, padding=pad,
                                         input_hw=(h, w)), want_dx)
    _assert_close(conv.conv2d_kernel_grad(tx, tg, stride=stride, padding=pad),
                  want_dw)
    pads = kernel_ops.conv_input_grad_pads(h, w, k, k, stride, pad, oh, ow)
    dx = kernel_ops.conv_direct(tg, tw, stride=1, pads=pads, dil=stride,
                                flip=True)
    _assert_close(dx, want_dx)
    dw = kernel_ops.conv_dw(tx, tg, stride=stride, padding=pad, kh=k, kw=k)
    # The reference's named dW op covers H + 2p - (OH-1)s taps, which is
    # past the kernel where (H + 2p - k) is not a multiple of the stride.
    _assert_close(dw, np.asarray(want_dw)[:k, :k])


@pytest.mark.parametrize("stride,pads,dil", [
    (1, (0, 0, 0, 0), 1), (2, (1, 1, 1, 1), 1), (3, (2, 0, 1, 2), 1),
    (1, (1, 2, 0, 1), 2), (2, (2, 1, 1, 1), 3)])
def test_conv_direct_plain_geometry(stride, pads, dil, no_launch):
    """The plain K4 against a direct loop over the dilated, padded
    input, at asymmetric pads and dilations; conv_out_hw agrees."""
    x, w = _rand(2, 5, 6, 3), _rand(3, 2, 3, 4, seed=1)
    got = kernel_ops.conv_direct(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=stride, pads=pads, dil=dil)
    n, h, wd, c = x.shape
    xd = np.zeros((n, (h - 1) * dil + 1, (wd - 1) * dil + 1, c), np.float32)
    xd[:, ::dil, ::dil] = x
    pt, pb, pl, pr = pads
    xp = np.pad(xd, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    oh, ow = kernel_ops.conv_out_hw(h, wd, 3, 2, stride, pads, dil)
    want = np.zeros((n, oh, ow, 4), np.float32)
    for oy in range(oh):
        for ox in range(ow):
            win = xp[:, oy * stride:oy * stride + 3, ox * stride:ox * stride + 2]
            want[:, oy, ox] = np.einsum("nyxc,yxco->no", win, w)
    _assert_close(got, want)
    flipped = kernel_ops.conv_direct(
        torch.from_numpy(x), torch.from_numpy(w[::-1, ::-1].transpose(0, 1, 3, 2)
                                              .copy()),
        stride=stride, pads=pads, dil=dil, flip=True)
    _assert_close(flipped, want, 1e-6)


def test_conv_dw_chunk_bounds_the_scratch():
    """K5's plan (`conv_dw_plan`, which replaced the per-pixel chunking):
    reference_cnn's conv1 and conv2 at batch 32 split their pixels into 64
    and 16 chunks of whole pixel tiles, summed in the kernel; a deep
    weight gradient (256 -> 256 channels over 32,768 pixels) keeps its
    partials within _DW_MAX_PARTIAL floats."""
    for (h, c, o, chunks) in ((28, 1, 16, 64), (14, 16, 32, 16)):
        oh = (h + 2 - 3) // 2 + 1
        for itemsize in (2, 4):
            plan = kernel_ops.conv_dw_plan(32, h, h, c, o, 3, 3, oh, oh, 2,
                                           itemsize=itemsize, x_ptr=0, g_ptr=0)
            assert plan.grid_m == chunks and plan.one_pass
            assert plan.scratch == chunks * 9 * c * o
    nout = 3 * 3 * 256 * 256
    for itemsize in (2, 4):
        plan = kernel_ops.conv_dw_plan(32, 32, 32, 256, 256, 3, 3, 32, 32, 1,
                                       itemsize=itemsize, x_ptr=0, g_ptr=0)
        assert plan.scratch <= kernel_ops._DW_MAX_PARTIAL
        assert plan.scratch == (plan.grid_m * nout if plan.grid_m > 1 else 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a CUDA tensor a wrapper launches or raises; its checks run
    before the launch (exercised here on meta tensors, which claim no
    card): a CPU tensor is the only way to the plain version."""
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        kernel_ops._check("gemm", meta)

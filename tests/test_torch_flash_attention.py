"""The port's flash attention and attention ops against the JAX package.

The JAX flash kernel runs as its own tests run it on the CPU: Pallas in
interpret mode, with its block caps lowered at run time where several
blocks are wanted. The port runs the kernels' plain PyTorch versions
(CPU tensors). Inputs come from a numpy seed and go to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_cuda_cnn_tpu.ops.pallas_attention as jfa
from mpi_cuda_cnn_tpu.ops.attention import attention as jax_attention
from mpi_cuda_cnn_tpu.ops.attention import blockwise_attention as jax_blockwise
from mpi_cuda_cnn_tpu.ops.losses import chunked_ce_mean as jax_chunked_ce
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
from mpi_cuda_cnn_tpu_torch.ops.attention import attention, blockwise_attention
from mpi_cuda_cnn_tpu_torch.ops.losses import chunked_ce_mean
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# float32: both sides are float32 math over at most 256 keys in other
# orders (the JAX kernel's online softmax, the port's full-matrix plain
# version): about 1e-6 of the values. bf16: the outputs and gradients
# carry 8 bits of mantissa (0.4%), and across several blocks the JAX
# kernel rounds p against a running max where the plain version rounds
# against the row max; relative to max|.|.
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # Round through bf16 once so both sides start from the same values.
    if dtype == "bfloat16":
        out = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in out]
    return out


def _both(arrays, dtype):
    return ([jnp.asarray(a, JDT[dtype]) for a in arrays],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrays])


def _close(got, want, rtol_of_max):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(jnp.asarray(got, jnp.float32)))
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float32)
    assert got.shape == want.shape
    tol = rtol_of_max * max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


@pytest.fixture
def small_blocks(monkeypatch):
    """Several q and k blocks at S = 256 in the JAX kernel."""
    for name in ("BLK_Q", "BLK_K", "BLK_Q_BF16", "BLK_K_BF16"):
        monkeypatch.setattr(jfa, name, 128)


# Head dims beyond the first cases' 32: instances the kernels are built
# for (80, 96) and dims the card pads to the next instance (24 -> 32,
# 48 -> 64), in both types, MHA and GQA 4/2 (the port's plain versions on
# the CPU; `test_pad_route_is_the_unpadded_plain_version` holds the pad
# route to them).
HEAD_DIMS = (24, 48, 80, 96)
FWD_CASES = [  # (heads, kv heads, causal, dtype, several blocks, head dim)
    (4, 4, True, "float32", False, 32),
    (4, 4, False, "float32", True, 32),
    (4, 2, True, "float32", True, 32),
    (4, 2, False, "bfloat16", False, 32),
    (4, 4, True, "bfloat16", True, 32),
    (4, 1, True, "bfloat16", True, 32),
] + [(4, hkv, True, dtype, True, d) for d in HEAD_DIMS
     for dtype in ("float32", "bfloat16") for hkv in (4, 2)]


@pytest.mark.parametrize("h,hkv,causal,dtype,multi,d", FWD_CASES,
                         ids=[f"h{c[0]}kv{c[1]}-{'causal' if c[2] else 'full'}-"
                              f"{c[3]}-{'multi' if c[4] else 'one'}"
                              + ("" if c[5] == 32 else f"-d{c[5]}")
                              for c in FWD_CASES])
def test_flash_forward_matches_the_pallas_kernel(monkeypatch, h, hkv, causal,
                                                 dtype, multi, d):
    if multi:
        for name in ("BLK_Q", "BLK_K", "BLK_Q_BF16", "BLK_K_BF16"):
            monkeypatch.setattr(jfa, name, 128)
    b, s = 1, 256
    arrays = _arrays([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)], dtype, 0)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    jo, jlse = jax.jit(lambda q, k, v: jfa._flash_forward(
        q, k, v, causal, with_lse=True))(jq, jk, jv)
    before = dict(_kernels.launches)
    to, tlse = fa.flash_forward(tq, tk, tv, causal)
    assert _kernels.launches == before        # CPU tensors: plain version
    assert to.dtype == TDT[dtype] and tlse.dtype == torch.float32
    assert tlse.shape == (b * h, s)
    _close(to, jo, FWD_TOL[dtype])
    _close(tlse, jlse, 1e-5)                  # float32 math on either type
    # The autograd function's forward is the same computation.
    _close(fa.flash_attention(tq, tk, tv, causal), jo, FWD_TOL[dtype])


GRAD_CASES = [(4, 4, "float32", 32), (4, 2, "float32", 32),
              (4, 4, "bfloat16", 32), (4, 2, "bfloat16", 32)] + [
    (4, hkv, dtype, d) for d in HEAD_DIMS
    for dtype in ("float32", "bfloat16") for hkv in (4, 2)]


@pytest.mark.parametrize("h,hkv,dtype,d", GRAD_CASES,
                         ids=[f"h{c[0]}kv{c[1]}-{c[2]}"
                              + ("" if c[3] == 32 else f"-d{c[3]}")
                              for c in GRAD_CASES])
def test_flash_gradients_match_the_pallas_kernel(small_blocks, h, hkv, dtype,
                                                 d):
    """Causal; dq, dk, dv of sum(o * w) for a random w, in each input's
    type, through the backward kernels' plain versions."""
    b, s = 1, 256
    arrays = _arrays([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                      (b, s, h, d)], dtype, 1)
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(arrays, dtype)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, True)
        return jnp.sum(o.astype(jnp.float32) * jw.astype(jnp.float32))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention(*leaves, True)
    tg = torch.autograd.grad((o.float() * tw.float()).sum(), leaves)
    for got, want, leaf in zip(tg, jg, leaves):
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        _close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("d", (24, 48, 80, 96, 130, 200))
def test_pad_route_is_the_unpadded_plain_version(d):
    """`pad_route`, the card's way to a head dim the kernels are not built
    at, run over the plain versions: q, k, v and dO zero-padded to the
    next instance, the real D's scale, the outputs sliced back, equal to
    the plain versions at D within 1e-6 (float32), forward and dq, dk, dv,
    causal and not, GQA 4/2; the padded columns come out zero."""
    dk = fa.kernel_head_dim(d)
    assert dk >= d and dk in fa.HEAD_DIMS
    arrays = _arrays([(2, 128, 4, d), (2, 128, 2, d), (2, 128, 2, d),
                      (2, 128, 4, d)], "float32", 5)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    seen = []

    def spy(fn):
        def run(*args, **kw):
            seen.append((args[0].shape[-1], kw["scale"]))
            return fn(*args, **kw)
        return run

    for causal in (True, False):
        o, lse = fa.flash_forward_plain(q, k, v, causal)
        dvec = fa.row_dvec(o, g)
        got = fa.pad_route(spy(fa.flash_forward_plain), q, k, v, causal,
                           out_f32=False)
        want = (o, lse)
        got += (fa.pad_route(spy(fa.flash_bwd_dq_plain), q, k, v, g, lse,
                             dvec, causal, grads_f32=False),)
        want += (fa.flash_bwd_dq_plain(q, k, v, g, lse, dvec, causal),)
        got += fa.pad_route(spy(fa.flash_bwd_dkv_plain), q, k, v, g, lse,
                            dvec, causal, grads_f32=False)
        want += fa.flash_bwd_dkv_plain(q, k, v, g, lse, dvec, causal)
        for a, w in zip(got, want, strict=True):
            assert a.shape == w.shape
            assert a.dim() == 2 or dk == d or a.is_contiguous()  # sliced
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                       atol=1e-6)
        # the padded columns of every output of the padded call are zero
        qp, kp, vp, gp = (torch.nn.functional.pad(t, (0, dk - d))
                          for t in (q, k, v, g))
        op, _ = fa.flash_forward_plain(qp, kp, vp, causal,
                                       scale=1.0 / d ** 0.5)
        dkp, dvp = fa.flash_bwd_dkv_plain(qp, kp, vp, gp, lse, dvec, causal,
                                          scale=1.0 / d ** 0.5)
        for t in (op, dkp, dvp):
            assert not t[..., d:].any()
    assert seen == [(dk, 1.0 / d ** 0.5)] * 6


def test_flash_head_dims_beyond_the_limit_raise_on_the_card_only():
    """A head dim beyond 256 has no kernel instance: the card's route
    raises ValueError naming the limit (no fallback); the CPU's plain
    versions take it."""
    q = torch.zeros(1, 128, 2, 320)
    with pytest.raises(ValueError, match="1..256"):
        fa.pad_route(fa.flash_forward_plain, q, q, q, True, out_f32=False)
    o, lse = fa.flash_forward(q, q, q, True)
    assert o.shape == q.shape and lse.shape == (2, 128)


def test_backward_kernels_split_as_the_reference():
    """flash_backward = row_dvec, then the dq and dk/dv wrappers."""
    arrays = _arrays([(2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32),
                      (2, 128, 4, 32)], "float32", 2)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    o, lse = fa.flash_forward(q, k, v, True)
    dvec = fa.row_dvec(o, g)
    assert dvec.shape == (8, 128)
    np.testing.assert_allclose(
        dvec.reshape(2, 4, 128).permute(0, 2, 1).numpy(),
        (g * o).sum(-1).numpy(), rtol=1e-6, atol=1e-6)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, g, True)
    torch.testing.assert_close(dq, fa.flash_bwd_dq(q, k, v, g, lse, dvec, True))
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, g, lse, dvec, True)
    torch.testing.assert_close(dk, dk2)
    torch.testing.assert_close(dv, dv2)


@pytest.mark.parametrize("shapes,match", [
    (((1, 130, 2, 32), (1, 130, 2, 32)), "multiple of 128"),
    (((1, 128, 3, 32), (1, 128, 2, 32)), "not a multiple of kv heads"),
    (((1, 128, 2, 32), (1, 256, 2, 32)), "do not match"),
], ids=["unaligned_seq", "head_divisibility", "kv_shape"])
def test_flash_refuses_what_the_reference_refuses(shapes, match):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k, True)
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_dkv(q, k, k, q, torch.zeros(1), torch.zeros(1), True)
    if match == "multiple of 128":   # the JAX kernel refuses it too
        with pytest.raises(ValueError, match=match):
            jfa.flash_attention(jnp.zeros(shapes[0]), jnp.zeros(shapes[1]),
                                jnp.zeros(shapes[1]))


def test_the_kernels_are_registered_for_the_build():
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert name in _kernels.KERNELS and _kernels.launches[name] >= 0
        assert (_kernels.CSRC / f"{name}.cu").exists()
    # the shared header is part of each library's hash
    assert (_kernels.CSRC / "flash_common.cuh").exists()


# ---------------------------------------------------------------------------
# The oracle attention ops and the chunked cross-entropy
# ---------------------------------------------------------------------------

ATTN_CASES = [(4, 4, True, "float32"), (4, 2, False, "float32"),
              (4, 1, True, "bfloat16")]


@pytest.mark.parametrize("h,hkv,causal,dtype", ATTN_CASES,
                         ids=[f"h{c[0]}kv{c[1]}-{c[2]}-{c[3]}" for c in ATTN_CASES])
def test_attention_oracle_matches_jax(h, hkv, causal, dtype):
    """Value and gradients (float32 leaves) of the quadratic oracle."""
    arrays = _arrays([(2, 64, h, 16), (2, 64, hkv, 16), (2, 64, hkv, 16),
                      (2, 64, h, 16)], dtype, 3)
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(arrays, dtype)

    def jloss(q, k, v):
        o = jax_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * jw.astype(jnp.float32)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = attention(*leaves, causal=causal)
    assert o.dtype == TDT[dtype]
    _close(o, jo, FWD_TOL[dtype])
    tg = torch.autograd.grad((o.float() * tw.float()).sum(), leaves)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax_and_the_oracle(causal):
    arrays = _arrays([(2, 64, 2, 16)] * 4, "float32", 4)
    (jq, jk, jv, jw), (tq, tk, tv, tw) = _both(arrays, "float32")
    jgrad = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_blockwise(
        q, k, v, block_size=16, causal=causal) * jw), argnums=(0, 1, 2)))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = blockwise_attention(*leaves, block_size=16, causal=causal)
    _close(o, jax_blockwise(jq, jk, jv, block_size=16, causal=causal), 1e-5)
    _close(o, attention(tq, tk, tv, causal=causal), 1e-5)
    for got, want in zip(torch.autograd.grad((o * tw).sum(), leaves),
                         jgrad(jq, jk, jv)):
        _close(got, want, 1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        blockwise_attention(tq, tk, tv, block_size=24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_ce_matches_jax(dtype):
    """Value and gradients (features, head) of the chunked cross-entropy;
    the features in the compute type, the head a float32 master."""
    b, s, d, vocab, chunk = 2, 64, 16, 48, 16
    feats, head = _arrays([(b, s, d), (d, vocab)], dtype, 5)
    targets = np.random.default_rng(6).integers(0, vocab, (b, s)).astype(np.int32)
    cd = None if dtype == "float32" else jnp.bfloat16
    jf = jnp.asarray(feats, JDT[dtype])
    jval, jg = jax.jit(jax.value_and_grad(
        lambda f, w: jax_chunked_ce(f, w, jnp.asarray(targets), chunk, cd),
        argnums=(0, 1)))(jf, jnp.asarray(head))
    tf = torch.from_numpy(feats).to(TDT[dtype]).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    val = chunked_ce_mean(tf, th, torch.from_numpy(targets), chunk,
                          None if dtype == "float32" else torch.bfloat16)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    for got, want in zip(torch.autograd.grad(val, (tf, th)), jg):
        _close(got, want, GRAD_TOL[dtype])
    # the dense form gives the same mean NLL
    logits = tf.detach().float() @ th.detach().to(val.dtype if cd is None else
                                                  torch.bfloat16).float()
    dense = torch.nn.functional.cross_entropy(logits.reshape(-1, vocab),
                                              torch.from_numpy(targets).long()
                                              .reshape(-1))
    np.testing.assert_allclose(val.item(), dense.item(), rtol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        chunked_ce_mean(tf, th, torch.from_numpy(targets), 24)

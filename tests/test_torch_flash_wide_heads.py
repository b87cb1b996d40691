"""Flash attention (K7, K8, K9) above head dim 256, where the kernels run
their wide form (`csrc/flash_common.cuh`: a block a (64-row tile, 64
output columns), the logits over the whole D recomputed by each column
chunk's block, D streamed through shared memory in 64-column chunks).

- The plain versions against the JAX package's flash kernel (Pallas in
  interpret mode, as its own tests run it) at D 300 and 320, S 128,
  causal and not, GQA 4/2, in float32 and bf16: o and lse, and dq, dk, dv
  of sum(o * w), within tests/test_torch_flash_attention.py's
  tolerances (relative to max|.|: float32 1e-5; bf16 2e-2 forward, 3e-2
  gradients).
- `kernel_head_dim` and the plans at every D from 257 to 1024: D runs at
  the next multiple of 64; K7's and K8's grids cover every (batch, query
  head, query tile, column chunk) once and K9's every (batch, kv head,
  key tile, column chunk), 256 threads and two (64, 64) float32 tiles of
  shared memory, no GQA scratch; `pad_route` at D 300 and 1000 equals the
  unpadded plain versions within 1e-6 of max|.|.
- A torch emulation of the wide kernels' arithmetic, block by block (the
  online softmax over 64-key tiles, each 64-column chunk of D summed from
  zero, p and ds rounded to the input type before their products, K9's
  query group summed in the block), against the plain versions at D 320
  within the same tolerances. The kernels themselves run only on the
  card, where chip_smoke.py holds them to the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_cuda_cnn_tpu.ops.pallas_attention as jfa
from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NEG_INF = -1e30
# the padded and unpadded plain versions sum over D in other orders
# (relative to max|.|, float32)
PAD_TOL = 1e-6
T, C = 64, 64          # a tile's rows, a column chunk


def _arrays(shapes, dtype, seed):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        out = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in out]
    return out


def _close(got, want, rtol_of_max):
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(jnp.asarray(got, jnp.float32)))
    want = (want.detach().float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want, jnp.float32), np.float32))
    assert got.shape == want.shape
    tol = rtol_of_max * max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


CASES = [(d, dtype, causal) for d in (300, 320)
         for dtype in ("float32", "bfloat16") for causal in (True, False)]


@pytest.mark.parametrize("d,dtype,causal", CASES,
                         ids=[f"d{d}-{t}-{'causal' if c else 'full'}"
                              for d, t, c in CASES])
def test_plain_matches_the_pallas_kernel(d, dtype, causal):
    b, s, h, hkv = 1, 128, 4, 2
    arrays = _arrays([(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                      (b, s, h, d)], dtype, d)
    jq, jk, jv, jw = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    tq, tk, tv, tw = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    jo, jlse = jax.jit(lambda q, k, v: jfa._flash_forward(
        q, k, v, causal, with_lse=True))(jq, jk, jv)
    to, tlse = fa.flash_forward(tq, tk, tv, causal)
    _close(to, jo, FWD_TOL[dtype])
    _close(tlse, jlse, 1e-5)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal)
        return jnp.sum(o.astype(jnp.float32) * jw.astype(jnp.float32))

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention(*leaves, causal)
    tg = torch.autograd.grad((o.float() * tw.float()).sum(), leaves)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plans_and_head_dims_from_257_to_1024(dtype):
    b, s, h, hkv = 2, 256, 8, 2
    tdt = TDT[dtype]
    for d in range(257, 1025):
        dk = fa.kernel_head_dim(d)
        assert dk % 64 == 0 and d <= dk < d + 64 and fa.is_wide(dk)
        f = fa.flash_fwd_plan(b, s, h, hkv, dk, tdt)
        dq = fa.flash_bwd_plan("dq", b, s, h, hkv, dk, tdt)
        dkv = fa.flash_bwd_plan("dkv", b, s, h, hkv, dk, tdt)
        tiles = s // 64 * (dk // 64)
        assert (f.grid_x, f.grid_y) == (dq.grid_x, dq.grid_y) == (b * h, tiles)
        assert (dkv.grid_x, dkv.grid_y) == (b * hkv, tiles)
        for p in (f, dq, dkv):
            assert p.threads == 256 and p.smem_bytes == 2 * 64 * 68 * 4
        assert dq.scratch is dkv.scratch is None
        assert dq.sum_blocks == dkv.sum_blocks == 0
        if dk != d:   # a plan is made at the padded head dim only
            with pytest.raises(ValueError):
                fa.flash_fwd_plan(b, s, h, hkv, d, tdt)


@pytest.mark.parametrize("d", (300, 1000))
def test_pad_route_beyond_256_is_the_unpadded_plain_version(d):
    arrays = _arrays([(1, 128, 4, d), (1, 128, 2, d), (1, 128, 2, d),
                      (1, 128, 4, d)], "float32", 9)
    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    for causal in (True, False):
        o, lse = fa.pad_route(fa.flash_forward_plain, q, k, v, causal,
                              out_f32=False)
        wo, wlse = fa.flash_forward_plain(q, k, v, causal)
        _close(o, wo, PAD_TOL)
        _close(lse, wlse, PAD_TOL)
        dvec = fa.row_dvec(wo, g)
        dq = fa.pad_route(fa.flash_bwd_dq_plain, q, k, v, g, wlse, dvec,
                          causal, grads_f32=False)
        _close(dq, fa.flash_bwd_dq_plain(q, k, v, g, wlse, dvec, causal),
               PAD_TOL)
        dkv = fa.pad_route(fa.flash_bwd_dkv_plain, q, k, v, g, wlse, dvec,
                           causal, grads_f32=False)
        for a, w in zip(dkv, fa.flash_bwd_dkv_plain(q, k, v, g, wlse, dvec,
                                                    causal)):
            _close(a, w, PAD_TOL)


# ---------------------------------------------------------------------------
# The wide kernels' arithmetic, block by block
# ---------------------------------------------------------------------------


def _first(a, b):
    """a (..., 64, D) x b (..., 64, D)^T over D in 64-column chunks, each
    summed from zero and added (`wide_first`)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-2])
    for d0 in range(0, a.shape[-1], C):
        out = out + a[..., d0:d0 + C] @ b[..., d0:d0 + C].transpose(-1, -2)
    return out


def _mask(q0, k0, causal):
    i = q0 + torch.arange(T)[:, None]
    j = k0 + torch.arange(T)[None, :]
    return (j > i) if causal else torch.zeros(T, T, dtype=torch.bool)


def emulate_fwd(q, k, v, causal, rnd):
    """`flash_fwd_wide_kernel`: (o, lse), o (B, S, H, D) float32."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    o = torch.zeros(b, s, h, d)
    lse = torch.zeros(b, h, s)
    scale = 1.0 / d ** 0.5
    for hh in range(h):
        hk = hh // g
        for qt in range(s // T):
            q0 = qt * T
            rows = q[:, q0:q0 + T, hh]
            for c0 in range(0, d, C):
                m = torch.full((b, T), -float("inf"))
                l = torch.zeros(b, T)
                acc = torch.zeros(b, T, C)
                for kt in range((qt if causal else s // T - 1) + 1):
                    k0 = kt * T
                    keys = k[:, k0:k0 + T, hk]
                    masked = _mask(q0, k0, causal)
                    sc = torch.where(masked, NEG_INF, _first(rows, keys) * scale)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.where(masked, 0.0, torch.exp(sc - m_new[..., None]))
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + \
                        rnd(p) @ v[:, k0:k0 + T, hk, c0:c0 + C]
                    m = m_new
                lc = l.clamp_min(1e-30)
                o[:, q0:q0 + T, hh, c0:c0 + C] = acc / lc[..., None]
                lse[:, hh, q0:q0 + T] = m + torch.log(lc)
    return o, lse.reshape(b * h, s)


def _p_ds(rows, keys, drows, vals, lse_r, dvec_r, masked, scale, rnd):
    sc = _first(rows, keys)
    dp = _first(drows, vals)
    p = torch.where(masked, 0.0, torch.exp(sc * scale - lse_r[..., None]))
    return rnd(p), rnd(p * (dp - dvec_r[..., None]) * scale)


def emulate_dq(q, k, v, g, lse, dvec, causal, rnd):
    b, s, h, d = q.shape
    grp = h // k.shape[2]
    lse, dvec = lse.reshape(b, h, s), dvec.reshape(b, h, s)
    dq = torch.zeros(b, s, h, d)
    scale = 1.0 / d ** 0.5
    for hh in range(h):
        hk = hh // grp
        for qt in range(s // T):
            q0 = qt * T
            sl = slice(q0, q0 + T)
            for c0 in range(0, d, C):
                acc = torch.zeros(b, T, C)
                for kt in range((qt if causal else s // T - 1) + 1):
                    k0 = kt * T
                    ks = slice(k0, k0 + T)
                    _, ds = _p_ds(q[:, sl, hh], k[:, ks, hk], g[:, sl, hh],
                                  v[:, ks, hk], lse[:, hh, sl],
                                  dvec[:, hh, sl], _mask(q0, k0, causal),
                                  scale, rnd)
                    acc = acc + ds @ k[:, ks, hk, c0:c0 + C]
                dq[:, sl, hh, c0:c0 + C] = acc
    return dq


def emulate_dkv(q, k, v, g, lse, dvec, causal, rnd):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    grp = h // hkv
    lse, dvec = lse.reshape(b, h, s), dvec.reshape(b, h, s)
    dk, dv = torch.zeros(b, s, hkv, d), torch.zeros(b, s, hkv, d)
    scale = 1.0 / d ** 0.5
    for hk in range(hkv):
        for kt in range(s // T):
            k0 = kt * T
            ks = slice(k0, k0 + T)
            for c0 in range(0, d, C):
                acc_k, acc_v = torch.zeros(b, T, C), torch.zeros(b, T, C)
                for hh in range(hk * grp, (hk + 1) * grp):
                    for qt in range(kt if causal else 0, s // T):
                        q0 = qt * T
                        sl = slice(q0, q0 + T)
                        p, ds = _p_ds(q[:, sl, hh], k[:, ks, hk],
                                      g[:, sl, hh], v[:, ks, hk],
                                      lse[:, hh, sl], dvec[:, hh, sl],
                                      _mask(q0, k0, causal), scale, rnd)
                        acc_k = acc_k + ds.transpose(-1, -2) @ \
                            q[:, sl, hh, c0:c0 + C]
                        acc_v = acc_v + p.transpose(-1, -2) @ \
                            g[:, sl, hh, c0:c0 + C]
                dk[:, ks, hk, c0:c0 + C] = acc_k
                dv[:, ks, hk, c0:c0 + C] = acc_v
    return dk, dv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_emulation_matches_the_plain_versions(causal, dtype):
    arrays = _arrays([(1, 128, 4, 320), (1, 128, 2, 320), (1, 128, 2, 320),
                      (1, 128, 4, 320)], dtype, 3)
    q, k, v, g = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    qf, kf, vf, gf = (torch.from_numpy(a) for a in arrays)

    def rnd(x):
        return x.to(TDT[dtype]).float()

    o, lse = emulate_fwd(qf, kf, vf, causal, rnd)
    wo, wlse = fa.flash_forward_plain(q, k, v, causal)
    _close(rnd(o), wo, FWD_TOL[dtype])
    _close(lse, wlse, 1e-5)
    dvec = fa.row_dvec(wo, g)
    dq = emulate_dq(qf, kf, vf, gf, wlse, dvec, causal, rnd)
    _close(rnd(dq), fa.flash_bwd_dq_plain(q, k, v, g, wlse, dvec, causal),
           GRAD_TOL[dtype])
    dk, dv = emulate_dkv(qf, kf, vf, gf, wlse, dvec, causal, rnd)
    wk, wv = fa.flash_bwd_dkv_plain(q, k, v, g, wlse, dvec, causal)
    _close(rnd(dk), wk, GRAD_TOL[dtype])
    _close(rnd(dv), wv, GRAD_TOL[dtype])

"""The port's sequence-parallel attentions (`parallel/sp.py`) against the
JAX package's on the CPU: ring, ring-flash (the kernels' plain versions)
and Ulysses at worlds 2 and 4 of spawned gloo ranks, each rank holding
its sequence shard, against `make_ring_attention` /
`make_ring_flash_attention` / `make_ulysses_attention` on a seq mesh of
as many of conftest's host devices: every case at world 2, and the
causal GQA case of each attention at world 4. Every case of a world runs
in one spawn of its ranks; the parent puts the shards together and
compares:
forward within FWD_TOL and the gradients of sum(o * w) within GRAD_TOL
in float32, bf16 ring-flash within BF16_TOL of JAX's bf16 (its hops
merge in float32 on both sides). Also K7-K9's float32-output mode
against the reference's `out_f32` / `grads_f32` (Pallas in interpret
mode, as the JAX tests run it), head dim 16 through the plans and
`pick_attn_impl`, and Ulysses refusing a head count the axis does not
divide. The JAX package's modules are imported inside the functions
that use them: a spawned rank imports this module for `_attention_rank`
and needs none of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
from mpi_cuda_cnn_tpu_torch.parallel import sp
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh
from mpi_cuda_cnn_tpu_torch.train.lm import pick_attn_impl
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
RANKS_TIMEOUT_S = 240
B, H, D = 1, 4, 16
S_LOCAL = 128            # ring-flash's block granularity per shard
CASES = [  # (impl, causal, kv heads, dtype)
    ("ring", False, 4, "float32"),
    ("ring", True, 2, "float32"),
    ("ring_flash", False, 4, "float32"),
    ("ring_flash", True, 2, "float32"),
    ("ring_flash", True, 4, "bfloat16"),
    ("ulysses", False, 4, "float32"),
    ("ulysses", True, 2, "float32"),
]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WORLD_CASES = {2: range(len(CASES)), 4: (1, 3, 6)}
RUNS = [(w, n) for w, ns in WORLD_CASES.items() for n in ns]
IDS = ["w{}-{}-{}-kv{}-{}".format(w, CASES[n][0],
                                  "causal" if CASES[n][1] else "full",
                                  *CASES[n][2:]) for w, n in RUNS]


def _inputs(case_no: int, world: int, hkv: int, dtype: str):
    """q, k, v and the cotangent w of the whole sequence, float32 numpy
    (rounded through bf16 for a bf16 case)."""
    rng = np.random.default_rng(100 * world + case_no)
    s = S_LOCAL * world
    out = [rng.standard_normal(shape).astype(np.float32) for shape in
           ((B, s, H, D), (B, s, hkv, D), (B, s, hkv, D), (B, s, H, D))]
    if dtype == "bfloat16":
        out = [torch.from_numpy(a).bfloat16().float().numpy() for a in out]
    return out


def _attention_rank(mesh, world):
    """Every case on this rank's shard: (o, dq, dk, dv) as float32 numpy,
    dq/dk/dv of sum(o * w) on the rank's shard."""
    me = mesh.index("seq")
    sl = slice(me * S_LOCAL, (me + 1) * S_LOCAL)
    out = {}
    for n in WORLD_CASES[world]:
        impl, causal, hkv, dtype = CASES[n]
        q, k, v, w = (torch.from_numpy(a[:, sl].copy()).to(TDT[dtype])
                      for a in _inputs(n, world, hkv, dtype))
        leaves = [t.requires_grad_() for t in (q, k, v)]
        o = sp._BODIES[impl](*leaves, mesh, causal=causal)
        grads = torch.autograd.grad((o.float() * w.float()).sum(), leaves)
        out[n] = [t.detach().float().numpy() for t in (o, *grads)]
    return out


def _jax_case(n, world, impl, causal, hkv, dtype):
    from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mpi_cuda_cnn_tpu.parallel.sp import (
        make_ring_attention,
        make_ring_flash_attention,
        make_ulysses_attention,
    )

    makers = {"ring": make_ring_attention, "ring_flash":
              make_ring_flash_attention, "ulysses": make_ulysses_attention}
    mesh = jax_make_mesh({"seq": world}, devices=jax.devices()[:world])
    fn = makers[impl](mesh)
    q, k, v, w = (jnp.asarray(a, JDT[dtype])
                  for a in _inputs(n, world, hkv, dtype))

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(lambda *a: fn(*a, causal=causal), q, k, v)
        return (o, *vjp(w.astype(o.dtype)))

    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in run(q, k, v, w)]


@pytest.fixture(scope="module")
def world_runs():
    """world -> {case: its (o, dq, dk, dv), the ranks' shards put together
    in seq order}, one spawn per world on first use."""
    runs = {}

    def get(world):
        if world not in runs:
            ranks = run_ranks(_attention_rank, world, args=(world,),
                              axes={"seq": world}, timeout=RANKS_TIMEOUT_S)
            runs[world] = {n: [np.concatenate([r[n][i] for r in ranks],
                                              axis=1) for i in range(4)]
                           for n in WORLD_CASES[world]}
        return runs[world]

    return get


@pytest.mark.parametrize("world,n", RUNS, ids=IDS)
def test_sp_attention_matches_the_jax_package(world_runs, world, n):
    got = world_runs(world)
    impl, causal, hkv, dtype = CASES[n]
    want = _jax_case(n, world, impl, causal, hkv, dtype)
    fwd, grad = ((FWD_TOL, GRAD_TOL) if dtype == "float32"
                 else (BF16_TOL, BF16_TOL))
    for i, (g, w) in enumerate(zip(got[n], want, strict=True)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        tol = fwd if i == 0 else grad
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    mesh = Mesh(shape={"seq": 4}, rank=0, world=4, device=torch.device("cpu"),
                group=None)
    q = torch.zeros((1, 8, 6, D))
    with pytest.raises(ValueError, match="heads 6 not divisible by seq-axis "
                                         "size 4"):
        sp.ulysses_attention(q, q, q, mesh, causal=True)


# ---------------------------------------------------------------------------
# K7-K9's float32-output mode and head dim 16, plain versions vs Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
def test_f32_outputs_match_the_pallas_kernels(d, hkv):
    """bf16 inputs, causal: o and lse with out_f32, dq/dk/dv with
    grads_f32 against the reference's, float32 and unrounded on both
    sides (float32 math over bf16 operands in other orders)."""
    import mpi_cuda_cnn_tpu.ops.pallas_attention as jfa

    rng = np.random.default_rng(d + hkv)
    arrays = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .bfloat16() for s in ((1, 256, H, d), (1, 256, hkv, d),
                                    (1, 256, hkv, d), (1, 256, H, d))]
    q, k, v, g = arrays
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in arrays)
    jo, jlse = jfa._flash_forward(jq, jk, jv, True, with_lse=True,
                                  out_f32=True)
    o, lse = fa.flash_forward(q, k, v, True, out_f32=True)
    assert o.dtype == torch.float32 and jo.dtype == jnp.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    # the backward from the rounded o, as the reference's ring does
    o16 = o.bfloat16()
    jgrads = jfa._flash_backward(jq, jk, jv, jnp.asarray(o16.float().numpy(),
                                                         jnp.bfloat16),
                                 jlse, jg, True, grads_f32=True)
    grads = fa.flash_backward(q, k, v, o16, lse, g, True, grads_f32=True)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        tol = 3e-2 * max(float(np.abs(np.asarray(want)).max()), 1.0)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol
    # Without the flags the same calls round to the inputs' type.
    assert fa.flash_forward(q, k, v, True)[0].dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in
               fa.flash_backward(q, k, v, o16, lse, g, True))


def test_head_dim_16_is_built_for():
    assert 16 in fa.HEAD_DIMS
    assert pick_attn_impl("auto", 2048, "cuda") == "flash"
    for dtype in (torch.float32, torch.bfloat16):
        elem = 4 if dtype == torch.float32 else 2
        fwd = fa.flash_fwd_plan(8, 2048, 8, 8, 16, dtype)
        assert (fwd.grid_x, fwd.grid_y, fwd.threads) == (64, 32, 128)
        tiles = 5 if dtype == torch.bfloat16 else 4
        assert fwd.smem_bytes == tiles * 64 * (elem * 16 + 16)
        # rows of 32 or 64 bytes plus the pad stay 16-byte aligned
        assert (elem * 16 + 16) % 16 == 0
        for kernel in ("dq", "dkv"):
            plan = fa.flash_bwd_plan(kernel, 2, 1024, 4, 2, 16, dtype)
            assert plan.smem_bytes % 16 == 0 and plan.grid_y == 16

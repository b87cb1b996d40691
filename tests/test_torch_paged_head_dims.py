"""The paged-attention read (K1) at the head dims the reference takes
and the port's kernel refused before: not a multiple of 4 (6, 10), odd
(7: an odd last value column, 2-byte bf16 and 1-byte int8 page copies,
the unaligned output store), a multiple of 4 but not of 8 (20), and
above 256 (300, 320, 512, and the odd 321: a last column chunk of 65), in
all three page types.

- The plan (`paged_attention_plan`) takes each of them: every (slot, kv
  head, query row, page, output column) is covered by exactly one block
  (a block holds one chunk of at most 256 columns), the copies are
  `cp.async` wherever a pool row is 4-byte aligned and plain 2- or
  1-byte loads only where it is not, shared memory stays within the
  limit, and the only head dim it refuses is one whose one page stage
  does not fit (`max_head_dim`, which ROADMAP records at page size 16).
- `paged_attend_plain` matches the JAX package's `paged_attend` (its
  Pallas kernel in interpret mode) within tests/test_torch_paged_
  attention.py's tolerances (float32 and int8 atol 1e-5, bf16 1e-2),
  and so does the numpy emulation of the kernel's split-then-merge
  (tests/test_torch_paged_attention_plan.py's `emulate`) under each
  plan.
- The serve engine at D 6 and D 320 gives the JAX engine's tokens and
  `state_crc`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.ops.pallas_paged_attention import (
    paged_attend as jax_paged_attend,
)
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops.paged_attention import (
    max_head_dim,
    paged_attend_plain,
    paged_attention_plan,
)
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from test_torch_paged_attention_plan import PS, chunk_of, emulate
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

HEAD_DIMS = (6, 7, 10, 20, 300, 320, 321, 512)
DTYPES = ("float32", "bfloat16", "int8")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}
ELEM = {"float32": 4, "bfloat16": 2, "int8": 1}
ATOL = {"float32": 1e-5, "int8": 1e-5, "bfloat16": 1e-2}
SMEM_LIMIT = 226 * 1024
# (B, kk, H, Hkv, npages): decode over GQA 4/2, a chunk over MHA
SHAPES = ((3, 1, 4, 2, 5), (2, 4, 2, 2, 3))
# the largest head dim at page size 16 and 8 query rows a block
MAX_AT_16 = {"float32": 2232, "bfloat16": 3476, "int8": 4720}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS + (2232,))
def test_plan_takes_the_head_dim(hd, dtype):
    # and chip_smoke.py's head-dim cases (PAGED_HEAD_DIMS): the decode
    # tick over its 8 / 2 heads and 80 pages, and below the largest D the
    # prefill chunk (whose block table takes 64 more bytes a block)
    chunk = ((1, 32, 8, 2, 80),) if hd in HEAD_DIMS else ()
    for b, kk, h, hkv, npages in SHAPES + ((8, 1, 8, 2, 80),) + chunk:
        plan = paged_attention_plan(b, kk, h, hkv, hd, 16, npages, TDT[dtype])
        rows = (h // hkv) * kk
        assert plan.chunks == -(-hd // 256)
        assert 0 < plan.smem_bytes <= SMEM_LIMIT and plan.stages in (1, 2)
        row_bytes = hd * ELEM[dtype]
        assert row_bytes % plan.copy_bytes == 0
        # cp.async wherever the row allows it; plain loads only where not
        assert (plan.copy_bytes >= 4) == (row_bytes % 4 == 0)
        sp, rg, tile, ch = chunk_of(plan)
        slot, kvh = tile // hkv, tile % hkv
        assert (slot < b).all() and (rg * plan.warps < rows).all()
        cover = np.zeros((b, hkv, rows, npages, plan.chunks), np.int64)
        for s_, r_, b_, k_, c_ in zip(sp, rg, slot, kvh, ch):
            pages = slice(s_ * plan.pages_per_split,
                          min((s_ + 1) * plan.pages_per_split, npages))
            cover[b_, k_, r_ * plan.warps:(r_ + 1) * plan.warps, pages,
                  c_] += 1
        assert (cover == 1).all()
        if plan.splits > 1:
            ent = 2 + -(-min(hd, 256) // 2) * 2
            assert plan.scratch == (b, kk, h, plan.splits, plan.chunks * ent)
            assert plan.counters == b * hkv * plan.row_groups * plan.chunks


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_one_refusal_is_a_stage_that_does_not_fit(dtype):
    """max_head_dim is the largest head dim the plan takes at page 16, 8
    query rows and a page a split; one more is refused, and only by the
    stage's size."""
    top = max_head_dim(16, TDT[dtype])
    assert top == MAX_AT_16[dtype]
    plan = paged_attention_plan(8, 1, 8, 1, top, 16, 1, TDT[dtype])
    assert plan.stages == 1 and plan.pages_per_split == 1
    with pytest.raises(ValueError, match="does not fit"):
        paged_attention_plan(8, 1, 8, 1, top + 1, 16, 1, TDT[dtype])


def _case(seed, dtype, hd, b, kk, h, hkv, npages, pool=12):
    """Random pages (numpy, in the storage dtype), distinct block tables,
    positions ending mid-table (slot 0 inside its first page, the last
    slot's padding rows past the extent), and q."""
    rng = np.random.default_rng(seed)
    shape = (pool, PS, hkv, hd)
    if dtype == "int8":
        pages = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "ks": rng.uniform(0.001, 0.02, shape[:-1] + (1,)
                                   ).astype(np.float32),
                 "vs": rng.uniform(0.001, 0.02, shape[:-1] + (1,)
                                   ).astype(np.float32)}
    else:
        pages = {n: np.asarray(jnp.asarray(
            rng.normal(size=shape).astype(np.float32), jnp.dtype(dtype)))
            for n in ("k", "v")}
    table = np.stack([rng.choice(np.arange(1, pool), npages, replace=False)
                      for _ in range(b)]).astype(np.int32)
    last = np.linspace(PS // 2, npages * PS + kk, b).astype(np.int64)
    positions = np.maximum(last[:, None] - kk + 1 + np.arange(kk)[None, :],
                           0).astype(np.int32)
    q = rng.normal(size=(b, kk, h, hd)).astype(np.float32)
    return q, pages, table, positions


def _torch_pages(pages, dtype):
    out = {}
    for n, a in pages.items():
        t = torch.from_numpy(np.array(a, np.float32) if a.dtype != np.int8
                             else a.copy())
        out[n] = t.to(TDT[dtype]) if n in ("k", "v") else t
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_and_emulation_match_jax(hd, dtype):
    for i, (b, kk, h, hkv, npages) in enumerate(SHAPES):
        q, pages, table, positions = _case(hd + i, dtype, hd, b, kk, h, hkv,
                                           npages)
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
               "int8": jnp.int8}[dtype]
        jc = {n: jnp.asarray(a, jdt if n in ("k", "v") else jnp.float32)
              for n, a in pages.items()}
        want = np.asarray(jax_paged_attend(
            jnp.asarray(q), jc, jnp.asarray(positions), jnp.asarray(table),
            PS))
        got = paged_attend_plain(torch.from_numpy(q),
                                 _torch_pages(pages, dtype),
                                 torch.from_numpy(positions),
                                 torch.from_numpy(table), PS).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype],
                                   err_msg=f"plain D {hd} {dtype}")
        plan = paged_attention_plan(b, kk, h, hkv, hd, PS, npages,
                                    TDT[dtype])
        emu_pages = {n: (np.asarray(a, np.float32) if a.dtype != np.int8
                         else a) for n, a in pages.items()}
        with np.errstate(invalid="ignore", over="ignore"):
            emu = emulate(q, emu_pages, positions, table, plan)
        np.testing.assert_allclose(emu, want, rtol=0, atol=ATOL[dtype],
                                   err_msg=f"emulated D {hd} {dtype}")


WORKLOAD = dict(n=4, vocab=64, prompt_min=3, prompt_max=14, out_min=2,
                out_max=8, rate=0.0)


@pytest.mark.parametrize("hd,cache,jax_read", [(6, "int8", "pallas"),
                                               (320, "float32", "gather")],
                         ids=["d6-int8", "d320-f32"])
def test_engine_matches_jax(hd, cache, jax_read):
    """A PagedEngine whose heads are `hd` wide (4 query over 2 kv heads):
    the JAX engine's tokens and state_crc."""
    cfg = dict(vocab=64, dim=4 * hd, heads=4, kv_heads=2, depth=1,
               max_seq=48)
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
    jp = jm.init(jax.random.key(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(slots=2, num_pages=12, page_size=8, prefill_chunk=4,
              cache_dtype=cache, max_len=32, weights_dtype="float32")
    want = JaxEngine(jm, jp, attn_kernel=jax_read, **kw).run(
        jax_make_workload(seed=4, **WORKLOAD))
    got = PagedEngine(tm, tp, attn_kernel="cuda", device="cpu", **kw).run(
        make_workload(seed=4, **WORKLOAD))
    for a, b in zip(want.requests, got.requests):
        assert b.status == a.status == "finished"
        assert b.out == a.out, f"request {a.rid}"
    assert got.state_crc == want.state_crc

"""Model-parallel decoding with a head-sharded KV cache over the 'model'
axis (counterpart of the reference's sharded inference:
`parallel/tp.py` `shard_lm_params` places the standard params with the
Megatron specs of `lm_tp_specs`, and GSPMD partitions `generate`'s
prefill and cached decode from that placement, the cache head-sharded
because it is built from the sharded k/v projections).

Here one process is one rank, so the partition is written out once, as
a decoder that `models/generate.py`'s loops (`generate`,
`lookup_speculative_generate`, `speculative_generate`) take in place of
a params tree (`generate.decoder`):

- the rank's shards (`shard_decode_params`): the head-structured block
  leaves (`tp_sp.to_tp_layout`) sliced as the Megatron block slices
  them (`tp_sp.tp_block_spec`: wqkv / wq, wkv and w1 by columns, wo and
  w2 by rows, MoE w1 / w2 on the hidden dim with the gate whole), the
  token embedding and the head on the vocab; a leaf stays whole where
  the axis does not divide it (attention unless it divides both head
  counts, the MLP unless it divides the hidden, the vocab), as the
  reference's `shard` leaves it;
- the forward (`TPDecoder`): the embedding looked up on the rank's vocab
  rows and summed over the line (one rank holds each row, so the sum is
  exact), then each block through `tp_sp.tp_block_apply` (one
  all-reduce after wo and one after w2) with an attention that writes
  the rank's heads into its cache and reads them, then the head on the
  rank's vocab columns, the logits gathered whole before argmax or
  sampling;
- the cache: each rank's layers hold its Hkv / n kv heads, float32,
  bfloat16 or int8 (the per-(position, head) scales split with their
  heads).

Every rank of the model line runs the same loop: the gathered logits are
the same bytes on every rank, and the sampling noise is drawn from the
same key, so every rank picks the same tokens. The weights stay float32
and the products and the cache read are the plain ops, as in the
reference's model-parallel decode.
"""

from __future__ import annotations

import torch

from ..models.generate import CacheDecoder
from ..models.transformer import _layernorm
from ..ops.gemv import tree_map
from .collectives import GatherFromModel, ReduceFromModel
from .lm_shard import _paths
from .mesh import MODEL_AXIS, Mesh
from .tp import local_block, unflatten
from .tp_sp import to_tp_layout, tp_block_apply, tp_block_spec

# The dim of the rest leaves that 'model' splits on the vocab.
VOCAB_DIMS = {"tok_emb": 0, "head": 1}


def decode_split(model, n: int) -> tuple[bool, bool, dict[str, int]]:
    """(attention sliced, MLP sliced, {rest leaf: vocab dim split}) of a
    model on a model axis of n ranks: attention when n divides both head
    counts, the MLP when it divides the hidden (4 dim), the embedding
    and the head when it divides the vocab."""
    attn = not (model.heads % n or model.n_kv % n)
    mlp = not (4 * model.dim) % n
    vocab = {} if model.vocab % n else dict(VOCAB_DIMS)
    return attn, mlp, vocab


def shard_decode_params(model, params: dict, mesh: Mesh) -> dict:
    """This rank's shards of the standard params tree `params` (see the
    module docstring): the head-structured blocks sliced over 'model',
    the embedding and the head split on the vocab, each a tensor of its
    own."""
    attn, mlp, vocab = decode_split(model, mesh.shape.get(MODEL_AXIS, 1))
    full = to_tp_layout(params, model)
    out = {}
    for name, leaf in full.items():
        if name in vocab:
            out[name] = local_block(leaf.detach(), {MODEL_AXIS: vocab[name]},
                                    mesh).clone()
        elif name != "blocks":
            out[name] = tree_map(lambda t: t.detach().clone(), leaf)
    out["blocks"] = []
    for blk in full["blocks"]:
        leaves = [local_block(t.detach(), tp_block_spec(p, attn, mlp),
                              mesh).clone() for p, t in _paths(blk)]
        out["blocks"].append(unflatten(blk, leaves))
    return out


class TPDecoder(CacheDecoder):
    """The decoder of one rank of the model line (see the module
    docstring): `generate.CacheDecoder`'s `prefill(prompt, cache_dtype)`
    and `block(toks, pos, cache)` over this rank's `shards` (the
    head-structured layout, sliced over 'model' as `attn_sliced`,
    `mlp_sliced` and `vocab_split` say) and its `n_kv` heads of the
    cache; `cache_bytes` is the size of the rank's cache at its last
    prefill."""

    def __init__(self, model, shards: dict, mesh: Mesh, *,
                 attn_sliced: bool, mlp_sliced: bool,
                 vocab_split: dict[str, int]):
        self.model, self.p, self.mesh = model, shards, mesh
        self.attn_sliced, self.mlp_sliced = attn_sliced, mlp_sliced
        self.vocab_split = dict(vocab_split)
        n = mesh.shape.get(MODEL_AXIS, 1)
        self.n_kv = model.n_kv // n if attn_sliced else model.n_kv

    @classmethod
    def from_params(cls, model, params: dict, mesh: Mesh) -> "TPDecoder":
        """From the whole standard params, this rank's shards sliced
        (`shard_decode_params`)."""
        attn, mlp, vocab = decode_split(model, mesh.shape.get(MODEL_AXIS, 1))
        return cls(model, shard_decode_params(model, params, mesh), mesh,
                   attn_sliced=attn, mlp_sliced=mlp, vocab_split=vocab)

    @classmethod
    def from_sharded(cls, par, state: dict) -> "TPDecoder":
        """From a plain model mesh's live train state (`lm_shard.
        ShardedLM`, every block on every stage): the rank's shards as it
        trains them, its FSDP split gathered over the data line."""
        with torch.no_grad():
            shards = par.working(state["params"])
        return cls(par.model, shards, par.mesh, attn_sliced=par.attn_sliced,
                   mlp_sliced=par.mlp_sliced, vocab_split=par.vocab_split)

    # -- the forward ----------------------------------------------------

    def _embed(self, toks: torch.Tensor, positions: torch.Tensor):
        emb = self.p["tok_emb"]
        if "tok_emb" in self.vocab_split:
            rows = emb.shape[0]
            local = toks.long() - self.mesh.index(MODEL_AXIS) * rows
            mine = (local >= 0) & (local < rows)
            x = emb[local.clamp(0, rows - 1)].masked_fill(~mine[..., None],
                                                           0.0)
            x = ReduceFromModel.apply(x, self.mesh)
        else:
            x = emb[toks.long()]
        if self.model.pos == "learned":
            x = x + self.p["pos_emb"][
                positions.long().clamp(max=self.model.max_seq - 1)]
        return x

    def _forward(self, toks: torch.Tensor, positions: torch.Tensor, attend,
                 last_only: bool = False) -> torch.Tensor:
        """toks (B, k) at `positions` (k,) through the rank's blocks, with
        attend(i, q, k, v) the layer's cache write and read; the float32
        logits (B, k, vocab), or of the last position alone."""
        x = self._embed(toks, positions)
        for i, blk in enumerate(self.p["blocks"]):
            x, _ = tp_block_apply(
                self.model, blk, x, pos=positions, mesh=self.mesh,
                attn=lambda q, k, v, i=i: attend(i, q, k, v),
                attn_sliced=self.attn_sliced, mlp_sliced=self.mlp_sliced,
                moe_inference=True)
        if last_only:
            x = x[:, -1:]
        x = _layernorm(x, self.p["ln_f"]["g"], self.p["ln_f"]["b"])
        logits = x @ self.p["head"]
        if "head" in self.vocab_split:
            logits = GatherFromModel.apply(logits, self.mesh, -1)
        return logits.to(torch.float32)

    @torch.no_grad()
    def _prompt_logits(self, prompt, capture):
        positions = torch.arange(prompt.shape[1], device=prompt.device)
        return self._forward(prompt, positions,
                             lambda i, q, k, v: capture(q, k, v),
                             last_only=True)[:, 0, :]

    @torch.no_grad()
    def _block_logits(self, toks, positions, attend):
        return self._forward(toks, positions, attend)

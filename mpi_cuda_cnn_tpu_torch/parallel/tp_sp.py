"""The Megatron transformer block over the 'model' mesh axis, written
once for every LM mesh with a model axis (counterpart of the
reference's `parallel/tp_sp.py`).

The reference writes the block explicitly for its shard_map steps (TP x
SP, TP x PP and the full 4D mesh) and leaves the plain `data:N,model:M`
mesh to GSPMD placing the plain step (`parallel/tp.py` `lm_tp_specs`).
Here one process is one rank, so every mesh with a model axis runs this
block (`parallel/lm_shard.py` `ShardedLM`), and only the attention
callable differs between meshes: ring, ring-flash or Ulysses over
'seq' (`parallel/sp.py`), or the full-sequence flash kernels or oracle
(`train/lm.py`).

- The weights are held head-structured (`to_tp_layout`): wqkv
  (D, 3, H, hd), wq (D, H, hd), wkv (D, 2, Hkv, hd), wo (H, hd, D), so
  that a rank's heads are one block along the H dim. The fused wqkv's
  last dim in the standard tree interleaves q, k and v; a contiguous
  split of it would cut across them. `from_tp_layout` is the inverse
  (pure reshapes, bit for bit), for checkpoints, eval and decode.
- Megatron's pair (`parallel/collectives.py`): `CopyToModel` (the
  reference's `tp_copy`: identity forward, the gradient summed over the
  model line) at each parallel region's input, `ReduceFromModel`
  (`tp_reduce`: the partial outputs summed over the line, the gradient
  passed as it is) at its output. The qkv and w1 products are column
  parallel (the rank's heads or hidden slice), wo and w2 row parallel.
- MoE blocks run TP inside every expert: w1 (E, D, 4D) and w2
  (E, 4D, D) hold the hidden slice, the gate is replicated and enters
  the region through `CopyToModel`, so that its combine-path gradient
  is summed over the line; the balance loss is computed identically on
  every rank, and the caller weights it by 1/n_model in the
  differentiated loss (`ShardedLM`), so that the same sum restores one
  contribution of it.
- `attn_sliced` / `mlp_sliced` False keep that region whole on every
  rank with no collective, the fallback of the plain model mesh when
  the axis does not divide the heads (`lm_tp_specs`); `_check_tp_sp`
  refuses that on the meshes where the reference refuses it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import rope
from ..ops.gemv import tree_map
from .collectives import CopyToModel, ReduceFromModel
from .mesh import MODEL_AXIS, Mesh

# The dim of each head-structured block leaf that 'model' slices (the
# reference's TP_SPEC_TAILS), and of the MoE expert stacks under
# blk["moe"] (MOE_SPEC_TAILS): the single table of which weights are
# Megatron-sliced, read by the specs of every mesh with a model axis.
TP_SPEC_TAILS = {"wqkv": 2, "wq": 1, "wkv": 2, "wo": 0, "w1": 1, "w2": 0}
MOE_SPEC_TAILS = {"w1": 2, "w2": 1}
_ATTN_LEAVES = ("wqkv", "wq", "wkv", "wo")


def to_tp_layout(params: dict, model) -> dict:
    """Standard params -> the head-structured layout: wqkv (d, 3, H, hd),
    wq (d, H, hd), wkv (d, 2, Hkv, hd), wo (H, hd, d). Pure reshapes."""
    d, h, hd, hkv = model.dim, model.heads, model.head_dim, model.n_kv
    shapes = {"wqkv": (d, 3, h, hd), "wq": (d, h, hd),
              "wkv": (d, 2, hkv, hd), "wo": (h, hd, d)}
    return _reshape_blocks(params, shapes)


def from_tp_layout(params: dict, model) -> dict:
    """The inverse of `to_tp_layout` (for checkpoints, eval and decode)."""
    d, h, hd, hkv = model.dim, model.heads, model.head_dim, model.n_kv
    shapes = {"wqkv": (d, 3 * h * hd), "wq": (d, h * hd),
              "wkv": (d, 2 * hkv * hd), "wo": (h * hd, d)}
    return _reshape_blocks(params, shapes)


def _reshape_blocks(params: dict, shapes: dict) -> dict:
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: v.reshape(shapes[k]) if k in shapes else v
                      for k, v in blk.items()} for blk in params["blocks"]]
    return out


def _check_tp_sp(model, n_tp: int) -> None:
    """The reference's check of a strict Megatron mesh (TP x SP, TP x
    PP): the model axis divides the heads, the kv heads and the MLP
    hidden."""
    if model.heads % n_tp or model.n_kv % n_tp:
        raise ValueError(
            f"the model-axis size {n_tp} must divide both heads "
            f"{model.heads} and kv_heads {model.n_kv}")
    if (4 * model.dim) % n_tp:
        raise ValueError(f"MLP hidden {4 * model.dim} not divisible by "
                         f"model-axis size {n_tp}")


def tp_block_spec(path: tuple[str, ...], attn_sliced: bool,
                  mlp_sliced: bool) -> dict:
    """The model spec {MODEL_AXIS: dim} of a head-structured block leaf
    at `path` (its keys within the block), or {} when it stays whole."""
    if path[0] == "moe":
        dim = MOE_SPEC_TAILS.get(path[-1]) if mlp_sliced else None
    elif path[0] in _ATTN_LEAVES:
        dim = TP_SPEC_TAILS[path[0]] if attn_sliced else None
    else:
        dim = TP_SPEC_TAILS.get(path[0]) if mlp_sliced else None
    return {} if dim is None else {MODEL_AXIS: dim}


def tp_block_apply(model, blk: dict, x: torch.Tensor, *, attn,
                   pos: torch.Tensor, mesh: Mesh,
                   compute_dtype: torch.dtype | None = None,
                   attn_sliced: bool = True, mlp_sliced: bool = True,
                   moe_group=None, moe_dispatch_dtype=None,
                   moe_inference: bool = False):
    """One Megatron block on this rank's heads and hidden slice: x
    (B, S, D) replicated over the model line -> (x, aux), aux the MoE
    balance loss (0 dense), the same on every rank of the line. `blk`
    holds this rank's blocks of the head-structured leaves; `attn(q, k,
    v)` runs on the local heads; `moe_group` routes the tokens as
    `moe_mlp`'s `group` (None: this rank's tokens alone);
    `moe_inference` runs every expert with no drop (`moe_mlp_inference`,
    the decode's MoE; aux 0)."""
    from ..models.transformer import _layernorm, _weight_cast
    from .moe import moe_mlp, moe_mlp_inference

    w = _weight_cast(compute_dtype)
    b, s, d = x.shape
    y = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
    if attn_sliced:
        y = CopyToModel.apply(y, mesh)
    if "wqkv" in blk:
        wqkv = w(blk["wqkv"])
        qkv = (y @ wqkv.reshape(d, -1)).reshape(b, s, *wqkv.shape[1:])
        q, k, v = qkv.unbind(2)
    else:
        wq, wkv = w(blk["wq"]), w(blk["wkv"])
        q = (y @ wq.reshape(d, -1)).reshape(b, s, *wq.shape[1:])
        k, v = (y @ wkv.reshape(d, -1)).reshape(
            b, s, *wkv.shape[1:]).unbind(2)
    if model.pos == "rope":
        q, k = rope(q, pos), rope(k, pos)
    o = attn(q, k, v)
    wo = w(blk["wo"])
    part = o.reshape(b, s, -1).to(x.dtype) @ wo.reshape(-1, d)
    x = x + (ReduceFromModel.apply(part, mesh) if attn_sliced else part)
    y = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
    if mlp_sliced:
        y = CopyToModel.apply(y, mesh)
    if "moe" in blk:
        moe_p = tree_map(w, blk["moe"])
        if mlp_sliced:
            moe_p["gate"] = CopyToModel.apply(moe_p["gate"], mesh)
        if moe_inference:
            part = moe_mlp_inference(y.reshape(b * s, d), moe_p,
                                     n_experts=model.moe_experts,
                                     top_k=model.moe_top_k)
            aux = torch.zeros((), device=x.device)
        else:
            part, aux = moe_mlp(y.reshape(b * s, d), moe_p,
                                n_experts=model.moe_experts,
                                top_k=model.moe_top_k, group=moe_group,
                                dispatch_dtype=moe_dispatch_dtype)
        part = part.reshape(b, s, d).to(x.dtype)
    else:
        part = F.gelu(y @ w(blk["w1"]), approximate="tanh") @ w(blk["w2"])
        aux = torch.zeros((), device=x.device)
    return x + (ReduceFromModel.apply(part, mesh) if mlp_sliced
                else part), aux

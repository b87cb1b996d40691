"""Mixture-of-experts MLP blocks on one device, one data mesh or an
expert-parallel axis (counterpart of the reference's `parallel/ep.py`
`moe_mlp`; its EP train step is `parallel/ep.py`).

Mirrors, with the reference's arithmetic: `init_moe_params` (gate (D, E),
expert stacks w1 (E, D, H) and w2 (E, H, D), the same scales),
`router_dispatch` (top-k choice and capacity slots fused into one
(T, E, C) dispatch tensor and a (T, E) gate map), `top1_dispatch` /
`topk_dispatch` (the dense (dispatch, combine) view), `_expert_ffn`,
`moe_mlp` with `axis=None` (capacity routing, `dispatch_chunk`,
`dispatch_dtype`) and `moe_mlp_inference` (every token through every
expert, no drops: the decode and prefill semantic), and `moe_mlp` with
`axis` set: expert parallelism over a mesh axis ('expert' under EP x DP,
'seq' under EP x SP). There each rank routes its own tokens (the
capacity from its local count, the balance loss over them), a tiled
all-to-all over the axis turns the (E, C, D) dispatch buffer into
(E/P, P * C, D), every rank's slots for its E/P experts, the local
experts run (the full replicated stacks sliced at the axis index, or
stacks already E/P long), and the inverse all-to-all returns the
outputs to the tokens' owners (`parallel/sp.py` `_AllToAll`, whose
backward is the inverse).

Routing, as the reference routes:
- probabilities: softmax in float32 of x @ gate; choice j is the argmax
  of the probabilities with the earlier choices masked to -inf
  (`torch.argmax` documents the first maximal index, which is the order
  `jax.lax.top_k` gives on a tie);
- capacity C = max(1, ceil(T * k * cf / E)), by the reference's Python
  float floor-division; slots go by choice priority (every token's first
  choice before any second one), in token order within a choice; the
  queue arithmetic (cumsum positions, masks, `used`) stays float32;
- top-1 combines as dispatch contracted with the expert outputs, then
  scaled by the token's gate; top-k scales dispatch by the gate map, then
  contracts;
- the balance loss is the Switch loss over first choices, E * sum(f * p),
  formed once from summed per-expert statistics when chunked.

`dispatch_chunk` routes fixed-size chunks of tokens, each with its own
capacity; the reference's scan over chunks is here one batched
computation with the chunks on a leading axis (the same arithmetic per
chunk, launched once for all of them). `moe_mlp`'s stages carry the
reference's trace names (`obs.trace.annotate`): ep.router_build,
ep.dispatch_einsum, ep.expert_ffn, ep.combine_einsum.

Under data parallelism (`group`, a `parallel.mesh.Mesh` with a process
group) the reference's step is one GSPMD program that routes the GLOBAL
batch: the capacity comes from the global token count, slot positions
run over every rank's tokens in rank-major order (the order of
`dp_shard_batch`'s contiguous shards), and the balance loss uses global
means. A rank that routed only its own rows would drop other tokens and
train on another objective. So each MoE layer makes one all-reduce of
O(world * k * E) floats: every rank's per-choice expert counts (each
rank fills its own row, an all-gather by all-reduce, so that one
collective carries both) and the per-expert probability sums. A rank
offsets its positions by the earlier ranks' counts of the same choice
and the global `used` of the earlier choices; the aux loss takes the
global sums. The all-reduce's backward gives each rank's probabilities
world x the aux gradient (the sum over ranks of identical upstream
gradients, without a second collective), so that the DP step's mean over
ranks equals the global gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import prng
from ..obs.trace import annotate
from . import dp


def init_moe_params(key, dim: int, hidden: int, n_experts: int,
                    device: torch.device | str = "cpu") -> dict:
    """Gate (D, E) and expert-stacked MLP weights w1 (E, D, H), w2 (E, H,
    D): float32 normals from `split(key, 3)` (`data/prng.py`) on
    `device`, times the reference's float32 scales 1 / sqrt(D) and
    1 / sqrt(H)."""
    k1, k2, k3 = prng.split(key, 3)
    scale_in = float(np.float32(1) / np.sqrt(np.float32(dim)))
    scale_hid = float(np.float32(1) / np.sqrt(np.float32(hidden)))
    return {"gate": prng.normal(k1, (dim, n_experts), device) * scale_in,
            "w1": prng.normal(k2, (n_experts, dim, hidden), device) * scale_in,
            "w2": prng.normal(k3, (n_experts, hidden, dim), device)
            * scale_hid}


def capacity(tokens: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots per expert for `tokens` routed tokens: the reference's
    `max(1, -int(-t * top_k * capacity_factor // n_experts))`."""
    return max(1, -int(-tokens * top_k * capacity_factor // n_experts))


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with `jnp.einsum`'s type promotion (bf16 with float32 gives
    float32; torch's einsum wants one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def route_probs(x: torch.Tensor, gate_w: torch.Tensor, k: int):
    """(probs float32 (..., E), idx (..., k) int64, gates (..., k)): the
    router softmax of x @ gate_w, the top-k experts (choice j the first
    maximal index among those not yet chosen, as `lax.top_k` orders
    ties), their probabilities (k 1) or renormalized over the k (k > 1)."""
    probs = torch.softmax(_einsum("...d,de->...e", x, gate_w).float(), dim=-1)
    masked, picks = probs.detach().clone(), []
    for _ in range(k):
        j = torch.argmax(masked, dim=-1, keepdim=True)
        picks.append(j)
        masked.scatter_(-1, j, float("-inf"))
    idx = torch.cat(picks, dim=-1)
    vals = torch.gather(probs, -1, idx)
    gates = vals if k == 1 else vals / vals.sum(dim=-1, keepdim=True)
    return probs, idx, gates


class _SumOverRanks(torch.autograd.Function):
    """The sum of `t` over the mesh's ranks (one all-reduce). Backward:
    the incoming gradient times the world size, which is the all-reduce
    of the ranks' gradients where, as here, every rank's upstream
    gradient is the same (each rank forms the same global loss from the
    same sums)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.world = mesh.world
        out = t.detach().clone()
        dp.all_reduce_sum(out, mesh)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.world, None


def router_dispatch(x: torch.Tensor, gate_w: torch.Tensor, n_experts: int,
                    capacity: int, k: int = 1, dtype=None,
                    return_stats: bool = False):
    """The routing core for tokens x (T, D): top-k choice and capacity slot
    assignment in one (T, E, C) dispatch tensor built in `dtype` (default
    x.dtype) and a (T, E) float32 gate map. Returns (dispatch, gate_te,
    aux), aux the Switch balance loss over first choices, or with
    `return_stats` its additive per-expert statistics (first-choice count
    (E,), probability sum (E,))."""
    probs, idx, gates = route_probs(x, gate_w, k)
    dtype = dtype or x.dtype
    dispatch, gate_te = _dispatch(idx[None], gates[None], n_experts,
                                  capacity, dtype)
    onehot1 = _onehot(idx[:, 0], n_experts)
    if return_stats:
        return dispatch[0], gate_te[0], (onehot1.sum(0), probs.sum(0))
    aux = (onehot1.mean(0) * probs.mean(0)).sum() * n_experts
    return dispatch[0], gate_te[0], aux


def top1_dispatch(x, gate_w, n_experts: int, capacity: int):
    """Switch top-1 routing: (dispatch, combine, aux), the dense float32
    (T, E, C) view of `router_dispatch`."""
    return topk_dispatch(x, gate_w, n_experts, capacity, k=1)


def topk_dispatch(x, gate_w, n_experts: int, capacity: int, k: int = 2):
    """Top-k routing: (dispatch, combine, aux) with combine = dispatch *
    gate_te (exact: a token's chosen experts are distinct)."""
    dispatch, gate_te, aux = router_dispatch(x, gate_w, n_experts, capacity,
                                             k=k, dtype=torch.float32)
    return dispatch, dispatch * gate_te[:, :, None], aux


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _dispatch(idx, gates, n_experts: int, cap: int, dtype, before=None,
              total=None):
    """Slots of G groups of t tokens, each group routed with `cap` slots an
    expert: idx and gates (G, t, k) -> (dispatch (G, t, E, C) in `dtype`,
    gate_te (G, t, E) float32). `before` (k, 1, 1, E): each choice's
    counts from the earlier ranks of a group that spans ranks, `total`
    the same over the whole group (None: each group is this rank's
    alone). The queue arithmetic is float32 (exact small integers)."""
    g, t = idx.shape[:2]
    slots = torch.arange(cap, device=idx.device, dtype=torch.float32)
    dispatch = torch.zeros((g, t, n_experts, cap), dtype=dtype,
                           device=idx.device)
    gate_te = torch.zeros((g, t, n_experts), dtype=torch.float32,
                          device=idx.device)
    used = torch.zeros((g, 1, n_experts), dtype=torch.float32,
                       device=idx.device)
    for j in range(idx.shape[-1]):
        onehot = _onehot(idx[..., j], n_experts)                # (G, t, E)
        start = used if before is None else used + before[j]
        pos = (torch.cumsum(onehot, dim=1) - 1.0 + start) * onehot
        keep = (pos < cap).float() * onehot
        slot = ((pos * onehot).sum(-1, keepdim=True) == slots).to(dtype)
        dispatch = dispatch + keep.to(dtype)[..., None] * slot[:, :, None, :]
        gate_te = gate_te + keep * gates[..., j, None]
        if total is None:
            used = used + keep.sum(dim=1, keepdim=True)
        else:       # the group's kept count: min(its count, slots left)
            used = used + torch.minimum(total[j], cap - used)
    return dispatch, gate_te


def _expert_ffn(h: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """Batched expert MLP over (..., E, S, D) slots. `torch.relu`, whose
    gradient at exactly 0 is 0, as `jax.nn.relu`'s (not the CNN's
    `jnp.maximum(x, 0)`, whose is 1/2)."""
    return _einsum("...esh,ehd->...esd",
                   torch.relu(_einsum("...esd,edh->...esh", h, w1)), w2)


def _routing(t: int, n_experts: int, top_k: int, capacity_factor: float,
             dispatch_chunk: int, world: int, rank: int):
    """(groups, tokens a group, capacity, the ranks a group spans, this
    rank's index in its group) for t local tokens of `world` ranks."""
    t_all = t * world
    if not dispatch_chunk or dispatch_chunk >= t_all:
        return 1, t, capacity(t_all, top_k, capacity_factor, n_experts), \
            world, rank
    if t_all % dispatch_chunk:
        raise ValueError(f"tokens {t_all} not divisible by dispatch_chunk "
                         f"{dispatch_chunk}")
    cap = capacity(dispatch_chunk, top_k, capacity_factor, n_experts)
    if t % dispatch_chunk == 0:
        return t // dispatch_chunk, dispatch_chunk, cap, 1, 0
    if dispatch_chunk % t:
        raise ValueError(f"dispatch_chunk {dispatch_chunk} neither divides "
                         f"nor is a multiple of a rank's {t} tokens")
    span = dispatch_chunk // t
    return 1, t, cap, span, rank % span


def check_dispatch_chunk(tokens: int, dispatch_chunk: int,
                         world: int) -> None:
    """ValueError unless `world` ranks of `tokens` tokens each can route
    in chunks of `dispatch_chunk` (`moe_mlp`'s rule)."""
    _routing(tokens, 1, 1, 1.0, dispatch_chunk, world, 0)


def moe_mlp(x: torch.Tensor, params: dict, *, n_experts: int,
            capacity_factor: float = 1.25, top_k: int = 1,
            dispatch_chunk: int = 0, dispatch_dtype=None, group=None,
            axis: str | None = None):
    """MoE MLP with capacity routing for x (T, D): (y (T, D), aux).

    `dispatch_chunk` > 0 routes chunks of that many tokens, each with its
    own capacity, the aux loss formed once from the summed statistics;
    `dispatch_dtype` overrides the dispatch tensor's dtype (default
    x.dtype; its entries are exact 0/1 in any float type, and a product
    with a float32 operand promotes as `jnp.einsum` does). `group` (a data
    mesh with a process group) routes the ranks' tokens as one global
    batch, rank-major (module docstring). With `axis`, `group` is the
    rank's mesh and the experts are parallel over that axis: each rank
    routes its own tokens and the slots cross the axis by all-to-all
    (module docstring); `dispatch_chunk` is refused there."""
    t, d = x.shape
    if axis is not None:
        if dispatch_chunk and dispatch_chunk < t:
            raise ValueError(
                "dispatch_chunk is the SINGLE-DEVICE quadratic-dispatch "
                f"lever; under EP (axis={axis!r}) the mesh already shards "
                "the routed tokens — drop one of the two")
        return _moe_mlp_routed(x, params, n_experts, capacity_factor, top_k,
                               dispatch_dtype, (group, axis))
    world = 1 if group is None or group.group is None else group.world
    rank = 0 if world == 1 else group.rank
    chunked = bool(dispatch_chunk) and dispatch_chunk < t * world
    ng, tg, cap, span, at = _routing(t, n_experts, top_k, capacity_factor,
                                     dispatch_chunk, world, rank)
    dtype = dispatch_dtype or x.dtype
    xs = x.reshape(ng, tg, d)
    with annotate("ep.router_build"):
        probs, idx, gates = route_probs(xs, params["gate"], top_k)
        onehots = _onehot(idx, n_experts)                   # (G, t, k, E)
        first_count = onehots[:, :, 0].sum((0, 1))
        prob_sum = probs.sum((0, 1))
        before = total = None
        if world > 1:
            counts = torch.zeros((world, top_k, n_experts), device=x.device)
            counts[rank] = onehots.sum((0, 1))
            buf = _SumOverRanks.apply(
                torch.cat([counts.reshape(-1), prob_sum]), group)
            counts = buf[:-n_experts].detach().reshape(world, top_k,
                                                        n_experts)
            prob_sum = buf[-n_experts:]
            first_count = counts[:, 0].sum(0)
            if span > 1:
                lo = rank - at
                before = counts[lo:rank].sum(0)[:, None, None, :]
                total = counts[lo:lo + span].sum(0)[:, None, None, :]
        dispatch, gate_te = _dispatch(idx, gates, n_experts, cap, dtype,
                                      before, total)
        t_all = t * world
        if chunked or world > 1:
            aux = ((first_count / t_all) * (prob_sum / t_all)).sum() \
                * n_experts
        else:
            aux = (onehots[0, :, 0].mean(0) * probs[0].mean(0)).sum() \
                * n_experts
    with annotate("ep.dispatch_einsum"):
        expert_in = _einsum("gtec,gtd->gecd", dispatch, xs)  # (G, E, C, D)
    with annotate("ep.expert_ffn"):
        expert_out = _expert_ffn(expert_in, params["w1"], params["w2"])
    with annotate("ep.combine_einsum"):
        if top_k == 1:
            y = _einsum("gtec,gecd->gtd", dispatch, expert_out)
            y = y * gate_te.sum(-1).to(y.dtype)[..., None]
        else:
            combine = dispatch * gate_te.to(dispatch.dtype)[..., None]
            y = _einsum("gtec,gecd->gtd", combine, expert_out)
    return y.reshape(t, d).to(x.dtype), aux


def _expert_slice(w: torch.Tensor, n_experts: int, p: int, i: int,
                  axis: str) -> torch.Tensor:
    """Rank i's E/p experts of a stack: the rows i*E/p.. of the full
    replicated stack, or the stack itself when it is E/p long already."""
    e_local = n_experts // p
    if w.shape[0] == e_local:
        return w
    if w.shape[0] != n_experts:
        raise ValueError(f"w1 holds {w.shape[0]} experts; expected "
                         f"{e_local} (sharded over {axis!r}) or {n_experts} "
                         "(replicated)")
    return w[i * e_local:(i + 1) * e_local]


def _moe_mlp_routed(x, params, n_experts, capacity_factor, top_k,
                    dispatch_dtype, ep):
    """`moe_mlp` with the experts parallel over `ep` = (mesh, axis): the
    rank's tokens routed at their own capacity, the dispatch buffer
    all-to-all'd to the experts' ranks and back."""
    from .sp import _AllToAll

    mesh, axis = ep
    t, d = x.shape
    p = mesh.shape[axis]
    if n_experts % p:
        raise ValueError(f"experts {n_experts} not divisible by axis size "
                         f"{p}")
    cap = capacity(t, top_k, capacity_factor, n_experts)
    with annotate("ep.router_build"):
        dispatch, gate_te, aux = router_dispatch(
            x, params["gate"], n_experts, cap, k=top_k,
            dtype=dispatch_dtype or x.dtype)
    with annotate("ep.dispatch_einsum"):
        expert_in = _einsum("tec,td->ecd", dispatch, x)         # (E, C, D)
    me = mesh.index(axis)
    w1 = _expert_slice(params["w1"], n_experts, p, me, axis)
    w2 = _expert_slice(params["w2"], n_experts, p, me, axis)
    with annotate("ep.all_to_all_dispatch"):
        expert_in = _AllToAll.apply(expert_in, mesh, 0, 1, axis)
    with annotate("ep.expert_ffn"):
        expert_out = _expert_ffn(expert_in, w1, w2)
    with annotate("ep.all_to_all_combine"):
        expert_out = _AllToAll.apply(expert_out, mesh, 1, 0, axis)
    with annotate("ep.combine_einsum"):
        if top_k == 1:
            y = _einsum("tec,ecd->td", dispatch, expert_out)
            y = y * gate_te.sum(-1).to(y.dtype)[:, None]
        else:
            combine = dispatch * gate_te.to(dispatch.dtype)[..., None]
            y = _einsum("tec,ecd->td", combine, expert_out)
    return y.to(x.dtype), aux


def moe_mlp_inference(x: torch.Tensor, params: dict, *, n_experts: int,
                      top_k: int = 1) -> torch.Tensor:
    """No-drop top-k MoE for inference, x (T, D) -> (T, D): every token
    through every expert, the router's choices selecting and weighting the
    outputs (token t's output depends on token t alone)."""
    probs, idx, gates = route_probs(x, params["gate"], top_k)
    h = torch.relu(_einsum("td,edh->teh", x, params["w1"]))
    y_all = _einsum("teh,ehd->ted", h, params["w2"])
    weight = torch.zeros_like(probs).scatter(-1, idx, gates)
    y = _einsum("ted,te->td", y_all, weight.to(y_all.dtype))
    return y.to(x.dtype)

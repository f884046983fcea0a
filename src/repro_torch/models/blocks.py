"""Transformer blocks as plain functions over parameter dicts.

Block contract:

    apply_block(kind, params, x, ctx, cache) -> (x_out, aux_loss)

where ``ctx`` carries positions, rotary tables and the config.
``cache=None`` means a full-sequence forward with no state; otherwise
``cache`` is this block's KV cache and is **updated in place** (the JAX
reference returns a new cache; writing the slots in place saves a copy of
the cache per layer and step).

This port covers the attention kinds and the RG-LRU mixer, each with a
dense gated FFN or a routed mixture of experts, and the mixer-only Mamba-2
(SSD) layer.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import WHOLE
from repro_torch.kernels.rglru.ref import rglru_gates
from repro_torch.kernels.ssd.ref import ssd_decode_step
from .config import ATTN_KINDS, ModelConfig
from .layers import act_fn, dense, gated_mlp, rmsnorm
from .rope import apply_rotary


# ---------------------------------------------------------------------------
# initialization helpers
# ---------------------------------------------------------------------------

def trunc_normal(shape: tuple, fan_in: int, *, lead: tuple = (), device,
                 dtype, generator: torch.Generator) -> torch.Tensor:
    """Truncated normal (±3σ) with std fan_in**-0.5, of shape lead + shape.

    Drawn in fp32 one ``shape`` slice at a time and cast to ``dtype`` as it
    goes, so a bf16 model never holds more than one fp32 slice beside its
    weights."""
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=device)
    std = fan_in ** -0.5
    for dst in out.view(-1, *shape):
        buf = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        dst.copy_(buf.mul_(std))
    return out


def init_attn(cfg: ModelConfig, *, lead: tuple = (), device, dtype,
              generator: torch.Generator) -> dict:
    D, dh = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    p = {
        "wq": trunc_normal((D, H * dh), D, **init),
        "wk": trunc_normal((D, K * dh), D, **init),
        "wv": trunc_normal((D, K * dh), D, **init),
        "wo": trunc_normal((H * dh, D), H * dh, **init),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", K * dh), ("bv", K * dh)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=device)
    return p


def init_ffn(cfg: ModelConfig, d_ff: int, *, lead: tuple = (), device, dtype,
             generator: torch.Generator) -> dict:
    D = cfg.d_model
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    return {
        "gate": trunc_normal((D, d_ff), D, **init),
        "up": trunc_normal((D, d_ff), D, **init),
        "down": trunc_normal((d_ff, D), d_ff, **init),
    }


def init_moe(cfg: ModelConfig, *, lead: tuple = (), device, dtype,
             generator: torch.Generator) -> dict:
    D, E = cfg.d_model, cfg.num_experts
    dff = cfg.moe_dff or cfg.d_ff
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    p = {
        "router": trunc_normal((D, E), D, **init),
        "w_gate": trunc_normal((E, D, dff), D, **init),
        "w_up": trunc_normal((E, D, dff), D, **init),
        "w_down": trunc_normal((E, dff, D), dff, **init),
    }
    if cfg.shared_expert_dff:
        p["shared"] = init_ffn(cfg, cfg.shared_expert_dff, **init)
    return p


def init_rglru(cfg: ModelConfig, *, lead: tuple = (), device, dtype,
               generator: torch.Generator) -> dict:
    D, W = cfg.d_model, cfg.resolved_lru_width
    Hb = cfg.num_heads
    bw = W // Hb
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)
    # a_param so that the decay a lies in (0.9, 0.999) (Griffin appendix):
    # log a = -8 softplus(a_param) r, r ~ 1  =>  a_param = softplus^-1(-log(u)/8)
    u = torch.empty(lead + (W,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    a_param = torch.log(torch.expm1(-torch.log(u) / 8.0))

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return {
        "in_x": trunc_normal((D, W), D, **init),
        "in_gate": trunc_normal((D, W), D, **init),
        "a_gate_w": trunc_normal((Hb, bw, bw), bw, **init),
        "a_gate_b": zeros(Hb, bw),
        "x_gate_w": trunc_normal((Hb, bw, bw), bw, **init),
        "x_gate_b": zeros(Hb, bw),
        "a_param": a_param.to(dtype),
        "conv_w": trunc_normal((W, cfg.ssm_conv), cfg.ssm_conv, **init),
        "conv_b": zeros(W),
        "out": trunc_normal((W, D), W, **init),
    }


def init_ssd(cfg: ModelConfig, *, lead: tuple = (), device, dtype,
             generator: torch.Generator) -> dict:
    D, di = cfg.d_model, cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * G * N
    init = dict(lead=lead, device=device, dtype=dtype, generator=generator)

    def per_head(v: torch.Tensor) -> torch.Tensor:
        return v.to(device=device, dtype=dtype).expand(lead + (H,)).clone()

    f32 = torch.float32
    return {
        "in_proj": trunc_normal((D, 2 * di + 2 * G * N + H), D, **init),
        "conv_w": trunc_normal((conv_ch, cfg.ssm_conv), cfg.ssm_conv, **init),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H, dtype=f32))),
        "D": torch.ones(lead + (H,), dtype=dtype, device=device),
        "dt_bias": per_head(torch.log(torch.expm1(
            torch.linspace(1e-3, 0.1, H, dtype=f32)))),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": trunc_normal((di, D), di, **init),
    }


def init_mixer(cfg: ModelConfig, kind: str, **init) -> dict:
    if kind in ATTN_KINDS:
        return init_attn(cfg, **init)
    if kind == "rglru":
        return init_rglru(cfg, **init)
    if kind == "ssd":
        return init_ssd(cfg, **init)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None):
    """x (B,S,C), w (C,K) depthwise, causal -> (out (B,S,C), new_state).

    With ``state`` (B,K-1,C) the conv consumes carried history; ``new_state``
    is the last K-1 inputs (None for K = 1).  Computed in ``x.dtype``."""
    K = w.shape[1]
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, K - 1, 0))
    out = F.conv1d(x_ext.transpose(1, 2), w.to(x.dtype)[:, None, :],
                   b.to(x.dtype), groups=x.shape[2]).transpose(1, 2)
    new_state = x_ext[:, x_ext.shape[1] - (K - 1):] if K > 1 else None
    return out, new_state


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------

def _attn_geometry(cfg: ModelConfig, kind: str):
    causal = cfg.causal and kind != "attn_bidir"
    window = cfg.window if kind in ("attn_sliding", "attn_local") else 0
    chunk = cfg.chunk_size if kind == "attn_chunked" else 0
    use_rope = cfg.pos_type != "none" and kind != "attn_global"  # iRoPE/NoPE
    return causal, window, chunk, use_rope


def attn_forward(p: dict, x: torch.Tensor, kind: str, ctx: dict,
                 cache: Optional[dict] = None):
    """Attention output; a given cache is written in place: prefill
    (S > 1, t == 0) fills slots [0, S) and ``pos[:S] = arange(S)`` (a prompt
    longer than the ring cache keeps its last Sc tokens, each at slot
    ``p % Sc``), decode writes slot ``t % Sc`` and ``pos[slot] = t``.
    On a ``model`` axis above 1 the block is tensor-parallel
    (``_attn_tp``), or, where H·dh does not divide over ``model`` (the
    rules' replicated weights), whole on every rank: through
    ``con.replicated`` without a cache, through ``_attn_tp``'s all-heads
    cache path with one (which may be split along the sequence)."""
    con = ctx.get("constrain", WHOLE)
    if con.size == 1:
        return _attn_whole(p, x, kind, ctx, cache)
    cfg: ModelConfig = ctx["cfg"]
    if cache is None and \
            p["wo"].shape[-2] == cfg.num_heads * cfg.resolved_head_dim:
        return con.replicated(lambda a: _attn_whole(p, a, kind, ctx), x)
    return _attn_tp(p, x, kind, ctx, cache)


def _attn_whole(p: dict, x: torch.Tensor, kind: str, ctx: dict,
                cache: Optional[dict] = None):
    """The block on whole heads: one device, or a block whose weights the
    rules replicate."""
    cfg: ModelConfig = ctx["cfg"]
    B, S, D = x.shape
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    causal, window, chunk, use_rope = _attn_geometry(cfg, kind)

    q = dense(x, p["wq"], p.get("bq")).reshape(B, S, H, dh)
    k = dense(x, p["wk"], p.get("bk")).reshape(B, S, K, dh)
    v = dense(x, p["wv"], p.get("bv")).reshape(B, S, K, dh)
    if use_rope:
        q = apply_rotary(q, ctx["cos"], ctx["sin"])
        k = apply_rotary(k, ctx["cos"], ctx["sin"])

    out = _attend(q, k, v, ctx, cache, causal, window, chunk)
    out = out.reshape(B, S, H * dh)
    return dense(out, p["wo"])


def _attend(q, k, v, ctx: dict, cache: Optional[dict], causal: bool,
            window: int, chunk: int):
    """Self-attention of q (B,S,Hx,dh) over k / v (B,S,Kx,dh), and the
    cache's writes and decode read where there is one (its Kx heads)."""
    B, S = q.shape[:2]
    if cache is None:  # full-sequence self-attention
        out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
    else:
        Sc = cache["k"].shape[1]
        t = ctx["t"]  # tokens already in the cache
        _write_slots(cache, k, v, t, 0, Sc)
        if S > 1:      # prefill (t == 0)
            out = kops.flash_attention(q, k, v, causal=causal, window=window,
                                       chunk=chunk)
        else:          # decode one token at position t
            q_pos = torch.full((B, 1), t, dtype=torch.int32, device=q.device)
            k_pos = cache["pos"][None].expand(B, Sc)
            out = kops.flash_attention(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                causal=causal, window=window, chunk=chunk, q_positions=q_pos,
                k_positions=k_pos)
    return out


def cache_slots(cfg: ModelConfig, kind: str, max_len: int) -> int:
    """The slots of a layer's KV ring: a window or chunk, or ``max_len``."""
    if kind in ("attn_sliding", "attn_local"):
        return min(cfg.window, max_len)
    if kind == "attn_chunked":
        return min(cfg.chunk_size, max_len)
    return max_len


def _write_slots(cache: dict, k, v, t: int, lo: int, Sc: int) -> None:
    """Write the new tokens' k / v (B, S, K, dh) into the slots
    [lo, lo + Sl) of a ring of Sc that ``cache`` holds (Sl its length; a
    whole cache: lo 0, Sl = Sc).  Prefill (S > 1, t == 0) fills slots
    [0, S) with positions 0..S-1, or, for a prompt longer than the ring,
    its last Sc tokens each at slot ``p % Sc``; decode writes slot
    ``t % Sc``."""
    S, Sl = k.shape[1], cache["k"].shape[1]
    dev = k.device
    if S > 1:                                       # prefill (t == 0)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        if S <= Sc:
            a, b = max(lo, 0), min(lo + Sl, S)
            if a < b:
                cache["k"][:, a - lo:b - lo] = k[:, a:b]
                cache["v"][:, a - lo:b - lo] = v[:, a:b]
                cache["pos"][a - lo:b - lo] = pos[a:b]
        else:
            shift = S % Sc
            cache["k"].copy_(torch.roll(k[:, S - Sc:], shift,
                                        dims=1)[:, lo:lo + Sl])
            cache["v"].copy_(torch.roll(v[:, S - Sc:], shift,
                                        dims=1)[:, lo:lo + Sl])
            cache["pos"].copy_(torch.roll(pos[S - Sc:], shift)[lo:lo + Sl])
    else:                                           # decode at position t
        slot = t % Sc
        if lo <= slot < lo + Sl:
            cache["k"][:, slot - lo] = k[:, 0]
            cache["v"][:, slot - lo] = v[:, 0]
            cache["pos"][slot - lo] = t


def _group_kv(k, v, q_heads: range, kv_lo: int, G: int):
    """k / v heads from ``kv_lo`` on, so that the flash kernel's grouping
    (query head i reads KV head i // (nq / nk)) gives each query head of
    ``q_heads`` its own KV head (h // G): as they are where that holds,
    else one KV head for each query head."""
    want = [h // G - kv_lo for h in q_heads]
    nq, nk = len(want), k.shape[2]
    if nq % nk == 0 and want == [i // (nq // nk) for i in range(nq)]:
        return k, v
    idx = torch.tensor(want, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _attn_tp(p: dict, x: torch.Tensor, kind: str, ctx: dict,
             cache: Optional[dict] = None):
    """Tensor-parallel attention (Megatron): wq / wk / wv column-parallel,
    wo row-parallel, its partial sums summed over ``model``.

    Rank r holds columns [r Cq, (r + 1) Cq) of wq and the same rows of wo.
    It computes the query heads those columns touch and the KV heads they
    read (h // G), gathering a projection's columns from the other ranks
    where the reference's rule cuts a head (it shards wk / wv whenever
    K·dh divides over ``model``, K = 2 on model 4 too: there each rank
    holds half a KV head), and keeps its Cq columns of the output.  A
    cache holds this rank's KV heads (K divides over ``model``), or all K
    heads, split along the sequence over ``ctx["kv_seq_axes"]`` (decode by
    ``parallel.flash_decode``) or whole.

    Weights that the rules replicate (serving only: a cache is given) give
    every rank all H query heads and the whole output, no partial sum."""
    cfg: ModelConfig = ctx["cfg"]
    con = ctx["constrain"]
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // K
    rep = p["wo"].shape[-2] == H * dh
    causal, window, chunk, use_rope = _attn_geometry(cfg, kind)
    r = 0 if rep else con.index
    h = x if rep else con.enter(x)
    B, S, _ = h.shape
    kv_sharded = p["wk"].shape[-1] != K * dh
    if kv_sharded:
        wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    else:           # replicated weights feeding this rank's heads only
        wk, wv = con.param(p["wk"]), con.param(p["wv"])
        bk, bv = (None if p.get(n) is None else con.param(p[n])
                  for n in ("bk", "bv"))
    q = dense(h, p["wq"], p.get("bq"))
    k = dense(h, wk, bk)
    v = dense(h, wv, bv)
    Cq = q.shape[-1]
    c0, c1 = r * Cq, (r + 1) * Cq
    hq = range(c0 // dh, -(-c1 // dh))
    kv0, kv1 = hq[0] // G, hq[-1] // G + 1

    def rope(t):
        return apply_rotary(t, ctx["cos"], ctx["sin"]) if use_rope else t

    full = {}

    def whole(name, t, sharded):
        if name not in full:
            full[name] = con.gather_last(t) if sharded else t
        return full[name]

    def heads(name, t, lo, hi, sharded):
        """Heads [lo, hi) of projection ``t`` (B, S, columns)."""
        C = t.shape[-1]
        if sharded and lo * dh == r * C and hi * dh == (r + 1) * C:
            cols = t
        else:
            cols = whole(name, t, sharded)[..., lo * dh:hi * dh]
        return cols.reshape(B, S, hi - lo, dh)

    qh = rope(heads("q", q, hq[0], hq[-1] + 1, not rep))
    all_kv = cache is not None and cache["k"].shape[2] == K
    if all_kv:
        # the cache holds every KV head: this rank writes its slots of them
        k_all = rope(heads("k", k, 0, K, kv_sharded))
        v_all = heads("v", v, 0, K, kv_sharded)
        axes = ctx.get("kv_seq_axes") or ()
        Sc = cache_slots(cfg, kind, ctx["max_len"]) if axes \
            else cache["k"].shape[1]
        idx, n = C.axes_index(ctx["mesh"], axes) if axes else (0, 1)
        split = bool(axes) and Sc % n == 0 and cache["k"].shape[1] != Sc
        t = ctx["t"]
        _write_slots(cache, k_all, v_all, t, idx * cache["k"].shape[1]
                     if split else 0, Sc)
        if S == 1 and split:
            # sequence-split cache -> distributed flash-decode on all heads
            from repro_torch.parallel.flash_decode import (
                seq_sharded_decode_attention)
            q_all = rope(heads("q", q, 0, H, not rep))
            out = seq_sharded_decode_attention(
                ctx["mesh"], axes, q_all, cache["k"].to(q.dtype),
                cache["v"].to(q.dtype), cache["pos"], t,
                batch_axes=ctx.get("kv_batch_axes", ()), causal=causal,
                window=window, chunk=chunk)
            out = dense(out.reshape(B, S, H * dh)[..., c0:c1], p["wo"])
            return out if rep else con.exit(out)
        if S == 1:
            kh, vh = _group_kv(cache["k"][:, :, kv0:kv1].to(q.dtype),
                               cache["v"][:, :, kv0:kv1].to(q.dtype), hq,
                               kv0, G)
            Sc = cache["k"].shape[1]
            out = kops.flash_attention(
                qh, kh, vh, causal=causal, window=window, chunk=chunk,
                q_positions=torch.full((B, 1), t, dtype=torch.int32,
                                       device=x.device),
                k_positions=cache["pos"][None].expand(B, Sc))
        else:
            kh, vh = _group_kv(k_all[:, :, kv0:kv1], v_all[:, :, kv0:kv1],
                               hq, kv0, G)
            out = kops.flash_attention(qh, kh, vh, causal=causal,
                                       window=window, chunk=chunk)
    else:
        kh = rope(heads("k", k, kv0, kv1, kv_sharded))
        vh = heads("v", v, kv0, kv1, kv_sharded)
        if cache is None:
            kh, vh = _group_kv(kh, vh, hq, kv0, G)
        out = _attend(qh, kh, vh, ctx, cache, causal, window, chunk)
    out = out.reshape(B, S, len(hq) * dh)
    out = dense(out[..., c0 - hq[0] * dh:c1 - hq[0] * dh], p["wo"])
    return out if rep else con.exit(out)


# ---------------------------------------------------------------------------
# MoE block (scatter-based dispatch with a capacity per expert)
# ---------------------------------------------------------------------------

_ROUTES: Optional[list] = None


@contextlib.contextmanager
def record_routes():
    """Collect ``(probs (B,S,E) fp32, sel (B,S,k))`` of every ``moe_forward``
    call inside the block, in call order (layer by layer), detached."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


def topk_margin(probs: torch.Tensor, k: int) -> float:
    """The smallest p_(k) - p_(k+1) over all tokens: how near the k-th and
    the (k+1)-th expert come to swapping places."""
    top = torch.topk(probs.float(), k + 1, dim=-1)[0]
    return float((top[..., k - 1] - top[..., k]).min())


def routes_differ(sel_a: torch.Tensor, sel_b: torch.Tensor) -> int:
    """Tokens whose sets of chosen experts differ (order within a token is
    not compared)."""
    a = torch.sort(sel_a.cpu(), dim=-1)[0]
    b = torch.sort(sel_b.cpu(), dim=-1)[0]
    return int((a != b).any(-1).sum())


def routes_by_layer(routes: list, n_runs: int) -> list:
    """``record_routes``' records of one forward pass, then of a prefill and
    its decode steps (``n_runs`` passes in all, each over the MoE layers in
    order), as (the forward's sel, the served sel joined along the
    sequence) for each MoE layer: the pairs to hand to ``routes_differ``."""
    n_moe = len(routes) // n_runs
    fwd, served = routes[:n_moe], routes[n_moe:]
    return [(fwd[i][1], torch.cat([r[1] for r in served[i::n_moe]], dim=1))
            for i in range(n_moe)]


def expert_ffn(p: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The stacked experts' gated FFN over a dispatch buffer (B,E,C+1,D):
    the C slots of every expert through three products over all E experts;
    the trash slot C comes back as zeros."""
    h = buf[:, :, :-1]                                             # (B,E,C,D)
    g = act_fn(act)(torch.einsum("becd,edf->becf", h,
                                 p["w_gate"].to(buf.dtype)))
    u = torch.einsum("becd,edf->becf", h, p["w_up"].to(buf.dtype))
    y = torch.einsum("becf,efd->becd", g * u, p["w_down"].to(buf.dtype))
    return F.pad(y, (0, 0, 0, 1))                      # restore slot C


def moe_forward(p: dict, x: torch.Tensor, ctx: dict):
    """x (B,S,D) -> (y (B,S,D), aux_loss fp32).  Each batch row is a
    dispatch group; capacity bounds each expert's buffer, and a (token,
    expert) pair past it is dropped (the reference's function, step for
    step).  ``torch.topk`` leaves the order of exactly tied probabilities
    unspecified where ``jax.lax.top_k`` takes the lower index first; random
    fp32 weights give no exact ties, and no tie-breaking is added here that
    the reference lacks.

    On a mesh (``ctx["constrain"]``) the rows stay the dispatch groups, so
    capacity and drops are a data shard's as they are the whole batch's;
    the load-balance loss's two means run over the global batch (summed
    over the data axes, each rank differentiating its own term).  Where
    the rules split the experts over ``model`` (E divides), rank r holds
    experts [r E/m, (r + 1) E/m): the router, the top-k and the slot
    bookkeeping run on the whole row, the same on every ``model`` rank,
    the experts' products on this rank's experts, the combine keeps the
    (token, k) pairs routed here, and one ``con.exit`` sums them with the
    column / row split shared expert; the aux loss's gradient is taken on
    ``model`` rank 0 alone, so that it counts once.  Where they replicate
    the experts every rank runs them all."""
    cfg: ModelConfig = ctx["cfg"]
    con = ctx.get("constrain", WHOLE)
    E, El = cfg.num_experts, p["w_gate"].shape[-3]
    ep = El != E                      # experts split over ``model``
    shared = p.get("shared")
    shared_split = shared is not None and ep and \
        shared["gate"].shape[-1] != cfg.shared_expert_dff
    if ep:          # the whole row on every rank, its gradient summed
        h, router = con.enter(x), con.param(p["router"])
    else:           # the whole row, the same on every rank
        h, router = con.gather_sequence(x), p["router"]
    B, S, D = h.shape
    kk = cfg.experts_per_token
    T = S * kk
    C = max(min(math.ceil(T * cfg.capacity_factor / E), T), 1)
    dev = h.device

    # the router in x's dtype, then fp32, as the reference computes it
    probs = torch.softmax(dense(h, router).float(), dim=-1)       # (B,S,E)
    w, sel = torch.topk(probs, kk, dim=-1)                         # (B,S,k)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    if _ROUTES is not None:
        _ROUTES.append((probs.detach(), sel.detach()))

    # ---- slot bookkeeping: the rank of each (token, k) within its expert,
    # from a stable sort of the expert ids (so ranks follow token order)
    e_flat = sel.reshape(B, T)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    seg_start = torch.searchsorted(e_sorted, experts)              # (B,E)
    ranks_sorted = (torch.arange(T, device=dev)[None]
                    - torch.gather(seg_start, 1, e_sorted))
    ranks = torch.empty_like(ranks_sorted).scatter_(1, order, ranks_sorted)
    # the pairs kept and routed to this rank's experts [e0, e0 + El)
    e0 = con.index * El if ep else 0
    here = (e_flat >= e0) & (e_flat < e0 + El)
    kept = (ranks < C) & here
    e_loc = torch.where(here, e_flat - e0, 0)
    pos = torch.where(kept, ranks, C)                  # overflow -> slot C

    # ---- dispatch: buf (B,El,C+1,D); slot C is the trash slot of the
    # pairs dropped or routed elsewhere.  They share one index, which
    # index_put_ writes in no set order on the card; the slot is never
    # read, so y does not depend on it (and its gradient there is zero)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, T)
    buf = h.new_zeros(B, El, C + 1, D)
    buf.index_put_((bidx, e_loc, pos), h.repeat_interleave(kk, dim=1))

    y_e = expert_ffn(p, buf, cfg.act)

    # ---- combine
    gathered = y_e[bidx, e_loc, pos]                               # (B,T,D)
    wk = (w.reshape(B, T) * kept).to(h.dtype)
    y = (gathered * wk[..., None]).reshape(B, S, kk, D).sum(2)

    if shared_split:
        y = con.exit(y + gated_mlp(h, shared, cfg.act))
    else:
        y = con.exit(y) if ep else con.to_sequence_shard(y)
        if shared is not None:
            y = y + _ffn(x, shared, cfg, con, cfg.shared_expert_dff)

    # ---- Switch-style load-balance aux loss (top-k picks distinct
    # experts, so the one-hot of sel has no count above one per token),
    # its means over the global batch
    n = B * S * con.dp_size
    chosen = torch.zeros(B, S, E, device=dev).scatter_(2, sel, 1.0)
    frac_tokens = con.dp_sum(chosen.sum((0, 1))) / n
    frac_probs = con.dp_sum(probs.sum((0, 1))) / n
    aux = E * (frac_tokens * frac_probs).sum()
    if ep and con.index:
        aux = aux.detach()
    return y, aux


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------

def rglru_forward(p: dict, x: torch.Tensor, ctx: dict,
                  cache: Optional[dict] = None):
    """RG-LRU mixer output; a given cache (``conv`` (B,K-1,W), ``h`` (B,W)
    fp32) is read as the carried state and written in place.  On a
    ``model`` axis above 1 the width is split (``_rglru_tp``) where it
    divides, else the block runs whole on every rank."""
    con = ctx.get("constrain", WHOLE)
    if con.size > 1 and p["in_x"].shape[-1] != ctx["cfg"].resolved_lru_width:
        return _rglru_tp(p, x, ctx, cache)
    return con.replicated(lambda a: _rglru_whole(p, a, cache), x)


def _rglru_whole(p: dict, x: torch.Tensor, cache: Optional[dict] = None):
    xb = dense(x, p["in_x"])
    gate = act_fn("gelu")(dense(x, p["in_gate"]))
    conv_state = cache["conv"] if cache is not None else None
    xb, new_conv = causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)
    log_a, gx = rglru_gates(xb, p)
    h0 = cache["h"] if cache is not None else None
    y, h_last = kops.rglru_scan(log_a, gx, h0)
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_last)
    y = y.to(x.dtype) * gate
    return dense(y, p["out"])


def _rglru_tp(p: dict, x: torch.Tensor, ctx: dict,
              cache: Optional[dict] = None):
    """The RG-LRU width split over ``model``: rank r holds channels
    [r Wl, (r + 1) Wl) of W.  ``in_x`` / ``in_gate`` column-parallel,
    ``out`` row-parallel; the conv taps, which the rules replicate, cut to
    this rank's channels (their gradient summed over ``model``); the gates
    block-diagonal on this rank's heads, or, where the heads do not divide
    (the rules replicate the gate weights), computed on the gathered width
    and cut to this rank's channels; the scan on (B, S, Wl).  The cache is
    whole along W on every rank (``cache_pspecs``): this rank reads
    its channels and writes back the whole width, gathered."""
    con = ctx["constrain"]
    h = con.enter(x)
    xb = dense(h, p["in_x"])
    gate = act_fn("gelu")(dense(h, p["in_gate"]))
    Wl = xb.shape[-1]
    cols = slice(con.index * Wl, (con.index + 1) * Wl)
    conv_state = cache["conv"][..., cols] if cache is not None else None
    xb, new_conv = causal_conv1d(xb, con.param(p["conv_w"])[cols],
                                 con.param(p["conv_b"])[cols], conv_state)
    if p["a_gate_w"].shape[-3] * p["a_gate_w"].shape[-1] == Wl:
        log_a, gx = rglru_gates(xb, p)
    else:
        whole = {n: con.param(p[n]) for n in ("a_gate_w", "a_gate_b",
                                              "x_gate_w", "x_gate_b")}
        whole["a_param"] = con.gather_last(p["a_param"])
        log_a, gx = (t[..., cols] for t in
                     rglru_gates(con.gather_last(xb), whole))
    h0 = cache["h"][:, cols].contiguous() if cache is not None else None
    y, h_last = kops.rglru_scan(log_a, gx, h0)
    if cache is not None:
        mesh = con.mesh
        cache["conv"].copy_(C.all_gather(new_conv, 2, mesh, ("model",)))
        cache["h"].copy_(C.all_gather(h_last, 1, mesh, ("model",)))
    y = y.to(x.dtype) * gate
    return con.exit(dense(y, p["out"]))


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def ssd_forward(p: dict, x: torch.Tensor, ctx: dict,
                cache: Optional[dict] = None):
    """Mamba-2 mixer output; a given cache (``conv`` (B,K-1,d_inner+2GN),
    ``state`` (B,H,P,N) fp32) is written in place.  Prefill (S > 1, t == 0)
    takes the state after the prompt from the scan itself, where the JAX
    reference folds ``ssd_decode_step`` over the prompt again: the same
    function, summed in another order.  Decode (S == 1) is
    ``ssd_decode_step``, on the card too, as in the JAX package."""
    cfg: ModelConfig = ctx["cfg"]
    B, S, _ = x.shape
    di, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim

    zxbcdt = dense(x, p["in_proj"])
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P).contiguous()
    Bm = Bm.reshape(B, S, G, N).contiguous()
    Cm = Cm.reshape(B, S, G, N).contiguous()
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])           # in the parameters' dtype

    if cache is None or S > 1:
        y, state = kops.ssd_scan(xs, dt, A, Bm, Cm, p["D"],
                                 chunk=cfg.ssm_chunk)
    else:
        state, y = ssd_decode_step(cache["state"], xs[:, 0], dt[:, 0], A,
                                   Bm[:, 0], Cm[:, 0], p["D"])
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(state)

    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z), p["norm"], eps=cfg.norm_eps)
    return dense(y, p["out_proj"])


# ---------------------------------------------------------------------------
# block application (pre-norm residual layer)
# ---------------------------------------------------------------------------

def _ffn(h: torch.Tensor, p: dict, cfg: ModelConfig, con,
         d_ff: int) -> torch.Tensor:
    """A dense gated FFN of hidden width ``d_ff``: gate / up
    column-parallel, down row-parallel on a ``model`` axis above 1, or
    whole on every rank where ``d_ff`` does not divide (the rules'
    replicated weights)."""
    if con.size == 1:
        return gated_mlp(h, p, cfg.act)
    if p["gate"].shape[-1] == d_ff:
        return con.replicated(lambda a: gated_mlp(a, p, cfg.act), h)
    return con.exit(gated_mlp(con.enter(h), p, cfg.act))


def apply_block(kind: str, p: dict, x: torch.Tensor, ctx: dict,
                cache: Optional[dict] = None):
    """One full layer: mixer + dense gated FFN or MoE (neither for
    mixer-only layers), pre-norm residuals.  Returns (x, aux_loss): the
    MoE's load-balance loss (fp32), the number 0.0 for a layer without one
    (no tensor made on the card per layer).

    ``ctx["constrain"]`` (``parallel.sharding.Constrainer``; none: one
    device) holds the mesh's layout, and each block runs the layout the
    rules give its weights: on a ``model`` axis above 1 attention, the
    FFN, the RG-LRU width and the MoE experts split where their widths
    divide (the experts where E does), whole on every rank where the rules
    replicate them, the SSD mixer (replicated) whole on every rank."""
    cfg: ModelConfig = ctx["cfg"]
    con = ctx.get("constrain", WHOLE)
    aux = 0.0
    h = rmsnorm(x, con.norm_scale(p["norm1"]), eps=cfg.norm_eps)
    if kind in ATTN_KINDS:
        mixed = attn_forward(p["mixer"], h, kind, ctx, cache)
    elif kind == "rglru":
        mixed = rglru_forward(p["mixer"], h, ctx, cache)
    elif kind == "ssd":
        mixed = con.replicated(
            lambda a: ssd_forward(p["mixer"], a, ctx, cache), h)
    else:
        raise ValueError(kind)
    x = x + mixed
    if "moe" in p or "ffn" in p:
        h = rmsnorm(x, con.norm_scale(p["norm2"]), eps=cfg.norm_eps)
        if "moe" in p:
            y, aux = moe_forward(p["moe"], h, ctx)
        else:
            y = _ffn(h, p["ffn"], cfg, con, cfg.d_ff)
        x = x + y
    return x, aux

"""Model assembly: embeddings → stacked superblocks → head.

Parameters mirror the JAX tree: per pattern position, each layer's tensors
are stacked along a leading superblock axis (``params["blocks"][pos]``), the
remainder layers are unstacked (``params["rem"]``).  The forward pass loops
over the leading axis where the reference scans.

Public entry points:

    init_params(cfg, device=..., dtype=..., generator=...) -> param dict
    param_specs(cfg, dtype=...)                         -> the same on "meta"
    forward_train(params, batch, cfg, dtype=..., remat_policy=...)
                                                        -> (logits, aux)
    init_cache(cfg, B, max_len, dtype, device=...)      -> decode cache
    prefill(params, batch, cache, cfg, dtype=...)       -> (last_logits, cache)
    decode_step(params, tokens, cache, cfg, dtype=...)  -> (logits, cache)

Weights are cast to the serving dtype once, at init or load
(``bridge.params_from_numpy``), in place of the reference's per-call
``cast_tree``: the same arithmetic.  The cache is updated in place and
``cache["t"]`` (tokens already in the cache) is a Python int.  ``aux`` is
the MoE load-balance loss summed over the layers in fp32 (0 for a model
without MoE); prefill and decode discard it, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.parallel import wrap_remat
from repro_torch.parallel.sharding import WHOLE
from . import blocks
from .config import ModelConfig
from .layers import embed, rmsnorm, unembed
from .rope import mrope_cos_sin, rope_cos_sin, text_positions3

# the audio stub's precomputed frame features (B, S, 512)
AUDIO_FEATURES = 512


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, layers: range, lead: tuple,
                **init) -> dict:
    """The tree of ``layers`` (their indices in the stack), stacked along
    ``lead``: an MoE from layer ``first_k_dense`` on, else a dense FFN if
    ``d_ff``.  The layers stacked together must agree, as the reference's
    stacking of their trees requires."""
    moe = {bool(cfg.num_experts) and i >= cfg.first_k_dense for i in layers}
    if len(moe) != 1:
        raise ValueError(f"{cfg.name}: first_k_dense={cfg.first_k_dense} "
                         "splits the layers of one pattern position")
    ones = dict(dtype=init["dtype"], device=init["device"])
    p = {"norm1": torch.ones(lead + (cfg.d_model,), **ones),
         "mixer": blocks.init_mixer(cfg, kind, lead=lead, **init)}
    if moe.pop():
        p["norm2"] = torch.ones(lead + (cfg.d_model,), **ones)
        p["moe"] = blocks.init_moe(cfg, lead=lead, **init)
    elif cfg.d_ff:
        p["norm2"] = torch.ones(lead + (cfg.d_model,), **ones)
        p["ffn"] = blocks.init_ffn(cfg, cfg.d_ff, lead=lead, **init)
    return p


def init_params(cfg: ModelConfig, *, device="cuda", dtype=torch.float32,
                generator: torch.Generator | None = None) -> dict:
    """Random weights: truncated normals (±3σ, std fan_in^-0.5) drawn tensor
    by tensor in fp32 and cast to ``dtype`` as they go; norms are ones and
    biases zeros.  ``generator`` (on ``device``) defaults to seed 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init = dict(device=device, dtype=dtype, generator=generator)
    D, V = cfg.d_model, cfg.vocab_size
    params = {"embed": blocks.trunc_normal((V, D), D, **init)}
    if cfg.modality == "audio_stub":
        params["frontend_proj"] = blocks.trunc_normal((AUDIO_FEATURES, D),
                                                      AUDIO_FEATURES, **init)
    n_pat, n_sb = len(cfg.block_pattern), cfg.n_superblocks
    params["blocks"] = [
        _init_block(cfg, kind, range(pos, n_sb * n_pat, n_pat), (n_sb,),
                    **init) for pos, kind in enumerate(cfg.block_pattern)]
    base = n_sb * n_pat
    params["rem"] = [_init_block(cfg, kind, range(base + j, base + j + 1), (),
                                 **init)
                     for j, kind in enumerate(cfg.remainder_pattern)]
    params["final_norm"] = torch.ones(D, dtype=dtype, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks.trunc_normal((D, V), D, **init)
    return params


def param_specs(cfg: ModelConfig, *, dtype=torch.float32) -> dict:
    """The parameter tree as "meta" tensors: shapes and dtypes, no storage
    and no random draws (the reference's ``eval_shape`` of ``init_params``)."""
    return init_params(cfg, device="meta", dtype=dtype,
                       generator=torch.Generator())


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ModelConfig, kind: str, B: int, max_len: int,
                      dtype, device, lead: tuple) -> dict:
    if kind == "ssd":
        conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {
            "conv": torch.zeros(lead + (B, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "state": torch.zeros(lead + (B, cfg.ssm_heads, cfg.ssm_head_dim,
                                         cfg.ssm_state),
                                 dtype=torch.float32, device=device),
        }
    if kind == "rglru":
        W = cfg.resolved_lru_width
        return {
            "conv": torch.zeros(lead + (B, cfg.ssm_conv - 1, W), dtype=dtype,
                                device=device),
            "h": torch.zeros(lead + (B, W), dtype=torch.float32,
                             device=device),
        }
    Sc = blocks.cache_slots(cfg, kind, max_len)
    K, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros(lead + (B, Sc, K, dh), dtype=dtype, device=device),
        "v": torch.zeros(lead + (B, Sc, K, dh), dtype=dtype, device=device),
        "pos": torch.full(lead + (Sc,), -1, dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    device = resolve_device(device)
    lead = (cfg.n_superblocks,)
    return {
        "blocks": [_init_block_cache(cfg, kind, batch, max_len, dtype, device,
                                     lead) for kind in cfg.block_pattern],
        "rem": [_init_block_cache(cfg, kind, batch, max_len, dtype, device, ())
                for kind in cfg.remainder_pattern],
        "t": 0,
    }


# ---------------------------------------------------------------------------
# forward machinery
# ---------------------------------------------------------------------------

def _make_ctx(cfg: ModelConfig, positions: torch.Tensor,
              positions3: torch.Tensor | None, t: int, constrain=None,
              extra_ctx: dict | None = None) -> dict:
    """cos / sin of the positions: M-RoPE takes ``positions3`` (3, B, S),
    or the text ids of ``positions`` where it is None.  ``constrain``: the
    mesh's ``Constrainer`` (none: one device); ``extra_ctx``: the serving
    context of ``train.steps.serve_extra_ctx`` (the mesh, the cache's
    sequence axes)."""
    dh = cfg.resolved_head_dim
    if cfg.pos_type == "mrope":
        p3 = positions3 if positions3 is not None else \
            text_positions3(positions)
        cos, sin = mrope_cos_sin(p3, dh, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.pos_type == "rope":
        cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
    else:
        cos = sin = None
    ctx = {"cfg": cfg, "cos": cos, "sin": sin, "t": t,
           "constrain": constrain or WHOLE}
    if extra_ctx:
        ctx.update(extra_ctx)
    return ctx


def _embed_tokens(tokens, table, cfg: ModelConfig, dtype, con):
    """The token embeddings.  A table split over ``model`` by vocabulary
    rows: each rank looks up the tokens in its rows (zeros elsewhere) and
    the partial embeddings are summed (reduce-scattered along the sequence
    under ``dp_sp``)."""
    if con.size == 1 or table.shape[0] == cfg.vocab_size:
        return con.to_sequence_shard(embed(tokens, table, dtype))
    rows = table.shape[0]
    local = tokens - con.index * rows
    hit = (local >= 0) & (local < rows)
    x = F.embedding(local.clamp(0, rows - 1), table)
    return con.exit(x.masked_fill(~hit[..., None], 0).to(dtype))


def _embed_inputs(params, batch, cfg: ModelConfig, dtype, con=WHOLE):
    """The token embeddings, or the stub frontends' inputs: the audio stub
    projects precomputed frame features (B, S, 512) to d_model
    (``frontend_proj`` column-parallel where d_model divides over
    ``model``, its output gathered); the vision stub scatters precomputed
    patch embeddings (B, n_img, D) over the positions where
    ``vision_mask`` (B, S) is True (early fusion).  Under ``dp_sp`` each
    rank's stream is its positions of the row."""
    if cfg.modality == "audio_stub":
        proj = params["frontend_proj"]
        x = batch["features"].to(dtype) @ proj.to(dtype)
        if proj.shape[-1] != cfg.d_model:
            x = con.gather_last(x, partial=False)
        return con.to_sequence_shard(x)
    x = _embed_tokens(batch["tokens"], params["embed"], cfg, dtype, con)
    if cfg.modality == "vision_stub" and "vision_embeds" in batch:
        x = _scatter_patches(x, batch["vision_embeds"].to(dtype),
                             batch["vision_mask"].bool(), con)
    return x


def _scatter_patches(x, ve, mask, con=WHOLE):
    """Patch j of each row (``ve`` (B, n_img, D)) in place of the j-th True
    position of the whole row (``mask`` (B, S)); a row with fewer Trues
    than n_img sends its last patches to False positions, which keep their
    token embedding.  ``x`` holds positions [lo, lo + Sl) of the rows
    (this rank's under ``dp_sp``, else all), and only the targets there
    are written."""
    B, S = mask.shape
    idx = torch.argsort((~mask).to(torch.int8), dim=1,
                        stable=True)[:, :ve.shape[1]]    # (B, n_img)
    j = torch.arange(idx.shape[1], device=x.device).expand_as(idx)
    src = torch.full((B, S), -1, dtype=torch.long, device=x.device)
    src.scatter_(1, idx, torch.where(torch.gather(mask, 1, idx), j, -1))
    Sl = x.shape[1]
    lo = con.index * Sl if con.sp else 0
    src = src[:, lo:lo + Sl]                               # (B, Sl)
    patch = torch.gather(ve, 1, src.clamp(min=0)[..., None].expand(
        B, Sl, ve.shape[-1]))
    return torch.where((src >= 0)[..., None], patch, x)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, so cache writes land in place)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_stack(params, x, cfg: ModelConfig, ctx, cache,
               remat_policy: str | None = None):
    """All layers in order: superblocks (one layer of each kind of
    ``cfg.block_pattern``), then the remainder layers; returns (x, the aux
    losses summed in fp32, superblock by superblock as the reference sums
    them: the number 0.0 where no layer has one).

    Under ``remat_policy`` each superblock, and each remainder layer, runs
    as one function under ``wrap_remat``: one checkpoint each, as the
    reference scans its superblocks.  Only the training forward wraps: with
    a cache, or with grad mode off, the stack runs unwrapped."""
    wrap = remat_policy if cache is None and torch.is_grad_enabled() else None

    def superblock(x, layers):
        """``layers``: (kind, params, cache) of each layer, in order."""
        aux = 0.0
        for kind, p, c in layers:
            x, a = blocks.apply_block(kind, p, x, ctx, c)
            aux = aux + a
        return x, aux

    run = wrap_remat(superblock, wrap)
    aux = 0.0
    for i in range(cfg.n_superblocks):
        x, a = run(x, [(kind, _layer(params["blocks"][pos], i),
                        None if cache is None else
                        _layer(cache["blocks"][pos], i))
                       for pos, kind in enumerate(cfg.block_pattern)])
        aux = aux + a
    for j, kind in enumerate(cfg.remainder_pattern):
        x, a = run(x, [(kind, params["rem"][j],
                        None if cache is None else cache["rem"][j])])
        aux = aux + a
    return x, aux


def _head(params, x, cfg: ModelConfig, con=WHOLE):
    """The final norm and the logits; a table split over ``model`` by
    vocabulary gives each rank its slice of the vocabulary's logits (the
    vocabulary-parallel head: ``layers.token_nll(..., vocab=)`` reduces
    them)."""
    x = rmsnorm(x, con.norm_scale(params["final_norm"].to(x.dtype)),
                eps=cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    rows = table.shape[0] if cfg.tie_embeddings else table.shape[1]
    x = con.enter(x) if rows != cfg.vocab_size else con.gather_sequence(x)
    return unembed(x, table, tied=cfg.tie_embeddings,
                   softcap=cfg.logit_softcap)


def _whole_vocab(logits, cfg: ModelConfig, con):
    """Logits of every word: gathered over ``model`` from a split head."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return con.gather_last(logits)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(params, batch, cfg: ModelConfig, *, dtype=torch.bfloat16,
                  remat_policy: str | None = None, constrain=None,
                  extra_ctx: dict | None = None):
    """Full-sequence forward; returns (logits (B,S,V), aux_loss).
    ``remat_policy`` (one of ``parallel.POLICIES``) checkpoints each
    superblock when grad mode is on.  On a mesh (``constrain``, the
    ``Constrainer`` of ``parallel.activation_constrainer``) ``params`` and
    ``batch`` are this rank's shards, and the logits are this rank's
    vocabulary slice where the head is split."""
    con = constrain or WHOLE
    x = _embed_inputs(params, batch, cfg, dtype, con)
    B, S = batch["tokens" if "tokens" in batch else "features"].shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    ctx = _make_ctx(cfg, positions, batch.get("positions3"), 0, con,
                    extra_ctx)
    x, aux = _run_stack(params, x, cfg, ctx, None, remat_policy)
    return _head(params, x, cfg, con), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


def prefill(params, batch, cache, cfg: ModelConfig, *, dtype=torch.bfloat16,
            constrain=None, extra_ctx: dict | None = None):
    """Process the prompt, fill the cache, return last-position logits only
    (never materializes (B,S,V))."""
    con = constrain or WHOLE
    x = _embed_inputs(params, batch, cfg, dtype, con)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    ctx = _make_ctx(cfg, positions, batch.get("positions3"), 0, con,
                    extra_ctx)
    x, _ = _run_stack(params, x, cfg, ctx, cache)
    cache["t"] = S
    logits = _head(params, x[:, -1:].contiguous(), cfg, con)
    return _whole_vocab(logits, cfg, con)[:, 0], cache


def decode_step(params, tokens, cache, cfg: ModelConfig, *,
                dtype=torch.bfloat16, constrain=None,
                extra_ctx: dict | None = None):
    """One decode step: tokens (B,1) int -> (logits (B,V), cache)."""
    con = constrain or WHOLE
    x = _embed_tokens(tokens, params["embed"], cfg, dtype, con)
    B = x.shape[0]
    t = cache["t"]
    positions = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
    ctx = _make_ctx(cfg, positions, None, t, con,  # text ids, as the reference
                    extra_ctx)
    x, _ = _run_stack(params, x, cfg, ctx, cache)
    cache["t"] = t + 1
    logits = _head(params, x, cfg, con)
    return _whole_vocab(logits, cfg, con)[:, 0], cache

"""Plain PyTorch Mamba-2 SSD (state-space duality) scan: the CPU path and the
oracle for the CUDA kernel.

Two scans of one function:

* ``ssd_sequential``: the exact recurrence, one timestep at a time (the
  ground truth, and the CPU path when S is not a multiple of the chunk).
* ``ssd_chunked``: the SSD chunked decomposition (intra-chunk quadratic term
  plus inter-chunk state passing), the algorithm the CUDA kernel implements,
  composed of its three phases, each the plain version of one launch of the
  kernel's mma body: ``ssd_chunk_state`` (each chunk's cumsum and local end
  state), ``ssd_state_passing`` (the state entering each chunk) and
  ``ssd_chunk_scan`` (y).  The phases take any S: like the kernel they pad
  the last chunk with dt = 0 and x = B = C = 0.

Shapes follow Mamba-2 (arXiv:2405.21060):

    x  (B, S, H, P)   values (P = head dim)
    dt (B, S, H)      positive step sizes (already softplus'ed)
    A  (H,)           negative real decay per head
    Bm (B, S, G, N)   input matrix  (G groups, N = state dim)
    Cm (B, S, G, N)   output matrix
    D  (H,)           skip connection

Recurrence per head h (group g = h // (H // G)):

    state_t = exp(dt_t A_h) * state_{t-1} + dt_t * x_t ⊗ B_t
    y_t     = C_t · state_t + D_h * x_t

Both scans start from a zero state and return ``(y, state)``: y in
``x.dtype`` and the fp32 state (B, H, P, N) after the last step.

``ssd_chunked_bwd`` is the plain backward of the chunked scan (the oracle for
the CUDA backward kernel, which nothing on the CPU path calls: autograd
differentiates the forward there), in the phases of the kernel's launches:
``ssd_chunk_state`` and ``ssd_chunk_dstate`` (each chunk's local state and
the gradient its outputs send to the state entering it), ``ssd_state_passing``
and ``ssd_state_passing_bwd`` (the states entering the chunks, and the
gradient of each chunk's local state, run in reverse), ``ssd_chunk_scan_bwd``
(every gradient inside a chunk) and ``ssd_sum_ordered`` (dA and dD summed over
the chunks in the kernel's fixed order; ``ssd_sum_slabs`` over the chunks'
slabs of P, where the kernel cuts P into slabs).
"""
from __future__ import annotations

import torch

# the TF32 split that split_einsum models the mma bodies with
from ..flash_attention.ref import truncate_tf32  # noqa: F401


def _expand_groups(Bm: torch.Tensor, H: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N) by repeating each group over its heads."""
    G = Bm.shape[2]
    assert H % G == 0
    return torch.repeat_interleave(Bm, H // G, dim=2)


def ssd_sequential(x, dt, A, Bm, Cm, D):
    """The recurrence one step at a time, fp32 internals."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    Bh = _expand_groups(Bm.to(f32), H)
    Ch = _expand_groups(Cm.to(f32), H)
    xf = x.to(f32)
    dtf = dt.to(f32)
    decay = torch.exp(dtf * A.to(f32))                  # (B,S,H)
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    ys = torch.empty((B, S, H, P), dtype=f32, device=x.device)
    for t in range(S):
        state = state * decay[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., :, None]
            * Bh[:, t, :, None, :])
        ys[:, t] = torch.einsum("bhpn,bhn->bhp", state, Ch[:, t])
    y = ys + xf * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


def split_bf16(v: torch.Tensor) -> torch.Tensor:
    """v as the mma body feeds an fp32 operand to the tensor cores: the sum
    of hi = bf16(v) and lo = bf16(v - hi), about 16 bits of mantissa."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, rnd):
    """``torch.einsum(eq, a, b)`` from split operands, as the backward's mma
    body forms its products on the tensor cores: each operand as hi =
    rnd(v) and lo = rnd(v - hi), and the product (lo·hi + hi·lo) + hi·hi,
    the two small terms first (lo·lo is dropped;
    ``flash_attention.ref.split_product`` for a matmul)."""
    a, b = a.float(), b.float()
    a_hi, b_hi = rnd(a), rnd(b)
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
    return ((torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo))
            + torch.einsum(eq, a_hi, b_hi))


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) -> (B, nc, chunk, ...), the last chunk padded with 0."""
    B, S = t.shape[:2]
    nc = -(-S // chunk)
    pad = torch.zeros((B, nc * chunk - S, *t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad], 1).reshape(B, nc, chunk, *t.shape[2:])


def ssd_chunk_state(x, dt, A, Bm, *, chunk: int = 128, round_operand=None,
                    product=torch.einsum):
    """Phase 1: (states (B,nc,H,P,N) fp32, cum (B,H,nc·chunk) fp32).

    cum is the within-chunk inclusive cumsum of dt·A; states[:, c] is the
    state chunk c leaves from a zero state, sum_j exp(total - cum_j) dt_j
    x_j B_jᵀ.  ``round_operand`` (None: exact fp32) is applied to the fp32
    operand w∘x, as the kernel rounds it for the tensor cores; ``product``
    (an einsum of two operands) forms the product (``split_einsum``: as
    the backward's mma body forms it)."""
    B, S, H, P = x.shape
    f32 = torch.float32
    xf = _chunked(x.to(f32), chunk)                         # (B,nc,Q,H,P)
    dtf = _chunked(dt.to(f32), chunk)                       # (B,nc,Q,H)
    Bh = _expand_groups(_chunked(Bm.to(f32), chunk).flatten(1, 2), H)
    Bh = Bh.reshape(*dtf.shape, -1)                         # (B,nc,Q,H,N)
    cum = torch.cumsum(dtf * A.to(f32), dim=2)              # inclusive
    w = torch.exp(cum[:, :, -1:] - cum) * dtf               # decay to the end
    wx = w[..., None] * xf
    if round_operand is not None:
        wx = round_operand(wx)
    states = product("bcqhp,bcqhn->bchpn", wx, Bh)
    return states, cum.permute(0, 3, 1, 2).reshape(B, H, -1)


def ssd_state_passing(states, cum, *, chunk: int = 128):
    """Phase 2: (states_in (B,nc,H,P,N), final state (B,H,P,N)), both fp32:
    the state entering each chunk and the state after the last."""
    B, nc, H, P, N = states.shape
    total = cum.reshape(B, H, nc, chunk)[..., -1]           # (B,H,nc)
    state = torch.zeros((B, H, P, N), dtype=torch.float32,
                        device=states.device)
    states_in = torch.empty_like(states)
    for c in range(nc):
        states_in[:, c] = state
        state = (state * torch.exp(total[:, :, c])[..., None, None]
                 + states[:, c])
    return states_in, state


def ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, *, chunk: int = 128,
                   round_operand=None, product=torch.einsum):
    """Phase 3: y (B,S,H,P) in ``x.dtype``: the intra-chunk term
    (C·Bᵀ ∘ L ∘ dt_j)·x, the inter-chunk term exp(cum_i) (C·state_in)
    and the D skip, rounded once.  ``round_operand`` (None: exact fp32) is
    applied to the fp32 operands the kernel rounds for the tensor cores:
    the scores and the state entering the chunk.  ``product`` (an einsum of
    two operands) forms the three products C·Bᵀ, scores·x and C·state_in
    (``split_einsum`` with ``truncate_tf32``: as the forward's mma_tf32x3
    body forms them)."""
    B, S, H, P = x.shape
    f32 = torch.float32
    xf = _chunked(x.to(f32), chunk)                         # (B,nc,Q,H,P)
    dtf = _chunked(dt.to(f32), chunk)                       # (B,nc,Q,H)
    Bh, Ch = (_expand_groups(_chunked(m.to(f32), chunk).flatten(1, 2), H)
              .reshape(*dtf.shape, -1) for m in (Bm, Cm))   # (B,nc,Q,H,N)
    nc = dtf.shape[1]
    cum = cum.reshape(B, H, nc, chunk).permute(0, 2, 3, 1)  # (B,nc,Q,H)

    # att[i,j] = exp(cum_i - cum_j) for i >= j.  The argument is masked
    # BEFORE the exp: masking the exp's output leaves exp(+big) = inf on the
    # dead branch, whose gradient is inf * 0 = NaN.
    li = cum[:, :, :, None, :]                              # (B,nc,Q,1,H)
    lj = cum[:, :, None, :, :]                              # (B,nc,1,Q,H)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    arg = torch.where(causal[None, None, :, :, None], li - lj,
                      torch.tensor(-1e30, dtype=f32, device=x.device))
    cb = product("bcqhn,bcshn->bcqsh", Ch, Bh)
    scores = cb * torch.exp(arg) * dtf[:, :, None]          # (B,nc,Q,Q,H)
    if round_operand is not None:
        scores = round_operand(scores)
        states_in = round_operand(states_in)
    y_intra = product("bcqsh,bcshp->bcqhp", scores, xf)
    y_inter = (torch.exp(cum)[..., None]
               * product("bcqhn,bchpn->bcqhp", Ch, states_in))
    y = (y_intra + y_inter).reshape(B, nc * chunk, H, P)[:, :S]
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """The SSD algorithm: O(S·chunk) intra-chunk + O(S/chunk) state pass,
    the three phases in order."""
    assert x.shape[1] % chunk == 0, (x.shape[1], chunk)
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    states_in, state = ssd_state_passing(states, cum, chunk=chunk)
    return ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in,
                          chunk=chunk), state


def ssd_chunk_dstate(dy, Cm, cum, *, chunk: int = 128, product=torch.einsum):
    """The gradient each chunk's outputs send to the state entering it,
    E (B,nc,H,P,N) fp32: sum_i (exp(cum_i) dy_i) C_iᵀ over the chunk (the
    transpose of y's inter-chunk term; padding contributes 0), the product
    formed by ``product``."""
    B, S, H, P = dy.shape
    dyf = _chunked(dy.to(torch.float32), chunk)             # (B,nc,Q,H,P)
    nc = dyf.shape[1]
    Ch = _expand_groups(_chunked(Cm.to(torch.float32), chunk).flatten(1, 2),
                        H).reshape(B, nc, chunk, H, -1)     # (B,nc,Q,H,N)
    cum = cum.reshape(B, H, nc, chunk).permute(0, 2, 3, 1)  # (B,nc,Q,H)
    return product("bcqhp,bcqhn->bchpn", torch.exp(cum)[..., None] * dyf, Ch)


def ssd_state_passing_bwd(dstates, cum, d_state=None, *, chunk: int = 128):
    """The reverse state pass: dstates (B,nc,H,P,N) holds each chunk's E
    (``ssd_chunk_dstate``); returns the gradient of each chunk's local end
    state (= of the state leaving it), fp32.  G_nc = ``d_state`` (or 0),
    G_c = exp(total_c) G_{c+1} + E_c, and chunk c's local state gets
    G_{c+1}."""
    B, nc, H, P, N = dstates.shape
    total = cum.reshape(B, H, nc, chunk)[..., -1]           # (B,H,nc)
    g = (torch.zeros((B, H, P, N), dtype=torch.float32,
                     device=dstates.device)
         if d_state is None else d_state.to(torch.float32))
    out = torch.empty_like(dstates)
    for c in reversed(range(nc)):
        out[:, c] = g
        g = g * torch.exp(total[:, :, c])[..., None, None] + dstates[:, c]
    return out


def _tree(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a pairwise tree (element k with k + half, the
    halves folded until one is left), zero-padded to a power of two."""
    t = t.movedim(dim, 0)
    n = 1 << max(t.shape[0] - 1, 0).bit_length()
    t = torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])
    while t.shape[0] > 1:
        half = t.shape[0] // 2
        t = t[:half] + t[half:]
    return t[0]


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, D, dy, cum, states_in, dstates, *,
                       chunk: int = 128, product=torch.einsum):
    """Every gradient inside the chunks, fp32, from the forward's cum and
    states_in (``ssd_chunk_state`` / ``ssd_state_passing``) and the
    gradients of the chunks' local states (``ssd_state_passing_bwd``).

    Returns (dx (B,S,H,P), ddt (B,S,H), dB and dC per head (B,S,H,N), and
    each chunk's part of dA and dD (B,nc,H)).  The intra-chunk term's
    transpose, the inter-chunk term's, the chunk state's and the D skip's,
    then d(dt·A): the reverse cumsum of d cum within the chunk plus the
    gradient of the chunk's total (through its decay in the state pass and
    in the weights exp(total - cum_j) of its local state), taken in the form
    whose large terms do not cancel (the scores' d cum is a row sum minus a
    column sum of R = dM ∘ M, and the weights' is cancelled by the total's):

        d(dt·A)_t = sum_{i >= t, j < t} R_ij
                    + sum_{i >= t} exp(cum_i) dy_i·Z_i
                    + sum_{i < t} w_i dw_i + exp(total) <dstate, state_in>

    with W = dy_i state_in (dC's inter-chunk term) giving the second term's
    dy_i·Z_i as C_i·W_i.  A chunk's dA and dD are summed over its tokens as
    a pairwise tree (``_tree``), as the kernel sums them.  ``product`` (an
    einsum of two operands) forms every product of two tensors."""
    B, S, H, P = x.shape
    f32 = torch.float32
    xf, dyf = (_chunked(t.to(f32), chunk) for t in (x, dy))  # (B,nc,Q,H,P)
    dtf = _chunked(dt.to(f32), chunk)                        # (B,nc,Q,H)
    nc = dtf.shape[1]
    Bh, Ch = (_expand_groups(_chunked(m.to(f32), chunk).flatten(1, 2), H)
              .reshape(B, nc, chunk, H, -1) for m in (Bm, Cm))
    cum = cum.reshape(B, H, nc, chunk).permute(0, 2, 3, 1)   # (B,nc,Q,H)
    total = cum[:, :, -1:]                                   # (B,nc,1,H)
    ecum = torch.exp(cum)
    to_end = torch.exp(total - cum)
    w = to_end * dtf                                         # (B,nc,Q,H)

    # L[i, j] = exp(cum_i - cum_j) for i >= j, the argument masked before
    # the exp (nothing above the diagonal is ever exp'ed to inf)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    arg = torch.where(causal, cum[:, :, :, None] - cum[:, :, None],
                      torch.tensor(-1e30, dtype=f32, device=x.device))
    L = torch.exp(arg)                                       # (B,nc,Q,Q,H)
    K = product("bcqhn,bcshn->bcqsh", Ch, Bh) * L       # C·Bᵀ ∘ L
    M = K * dtf[:, :, None]                                  # the scores
    dM = product("bcqhp,bcshp->bcqsh", dyf, xf)         # dy xᵀ
    dCB = dM * L * dtf[:, :, None]
    R = dM * M
    # sum_{i >= t, j < t} R_ij: R's suffix sums over i, then row t's j < t
    da = (R.flip(2).cumsum(2).flip(2)
          * (idx[None, :] < idx[:, None])[None, None, :, :, None]).sum(3)
    ddt = (dM * K).sum(2)
    dx = product("bcqsh,bcqhp->bcshp", M, dyf)
    # the chunk's local state sum_j w_j x_j B_jᵀ, whose gradient is dstates
    U = product("bcshn,bchpn->bcshp", Bh, dstates)
    dx = dx + w[..., None] * U + D.to(f32)[:, None] * dyf
    dw = (xf * U).sum(-1)
    ddt = ddt + to_end * dw
    wdw = w * dw
    da = da + torch.cat([torch.zeros_like(wdw[:, :, :1]),
                         wdw.cumsum(2)[:, :, :-1]], 2)
    da = da + (torch.exp(total[:, :, 0]) * (dstates * states_in).sum(
        (-1, -2)))[:, :, None]
    # the inter-chunk term exp(cum_i) C_i · state_in: W = dy state_in, and
    # dy_i · (C_i state_inᵀ) = C_i · W_i
    W = product("bcqhp,bchpn->bcqhn", dyf, states_in)
    ez = ecum * (Ch * W).sum(-1)
    da = da + ez.flip(2).cumsum(2).flip(2)
    dC = (product("bcqsh,bcshn->bcqhn", dCB, Bh) + ecum[..., None] * W)
    dB = (product("bcqsh,bcqhn->bcshn", dCB, Ch)
          + w[..., None] * product("bcshp,bchpn->bcshn", xf, dstates))
    ddt = ddt + A.to(f32) * da
    dA_parts = _tree(dtf * da, 2)
    dD_parts = _tree((xf * dyf).sum(-1), 2)

    def unchunk(t):
        return t.reshape(B, nc * chunk, *t.shape[3:])[:, :S]
    return (unchunk(dx), unchunk(ddt), unchunk(dB), unchunk(dC), dA_parts,
            dD_parts)


def ssd_sum_ordered(parts: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """(B,nc,H) per-chunk parts -> (H,) in the backward kernel's order:
    lane k of ``threads`` sums parts k, k + threads, ... (over the flat
    b·nc + c index) in turn, then a pairwise tree over the lanes."""
    B, nc, H = parts.shape
    flat = parts.reshape(B * nc, H)
    pad = -flat.shape[0] % threads
    flat = torch.cat([flat, flat.new_zeros((pad, H))]).reshape(-1, threads,
                                                                H)
    lanes = torch.zeros_like(flat[0])
    for row in flat:
        lanes = lanes + row
    return _tree(lanes, 0)


def ssd_sum_slabs(parts: list[torch.Tensor]) -> torch.Tensor:
    """Each slab of P's (B,nc,H) per-chunk parts -> (H,) in the backward
    kernel's order: the parts of chunk c's slabs after one another (chunk
    major, slab minor), then ``ssd_sum_ordered`` over them all."""
    B, nc, H = parts[0].shape
    return ssd_sum_ordered(torch.stack(parts, 2).reshape(B, nc * len(parts),
                                                         H))


def ssd_chunked_bwd(x, dt, A, Bm, Cm, D, dy, d_state=None, *,
                    chunk: int = 128, product=torch.einsum, slab=None):
    """The gradients (dx, ddt, dA, dBm, dCm, dD) of ``ssd_chunked``'s y and
    final state, given dy (like x) and ``d_state`` (B,H,P,N) or None (the
    final state unused), each in its input's dtype, computed in fp32.  Any S
    (the last chunk padded, as the kernel pads it).  dB and dC are summed
    over each group's heads in order; dA and dD over the chunks by
    ``ssd_sum_ordered``.  ``product`` (an einsum of two operands) forms
    every product of two tensors: ``split_einsum`` with ``truncate_tf32``
    models the mma body's 3xTF32 products.

    ``slab`` (None: the whole of P at once) cuts P into slabs of that many
    columns, as the backward's mma body cuts it past 64 (``slab=64``): every
    gradient inside the chunks is taken a slab at a time
    (``ssd_chunk_scan_bwd`` on the slab's columns of x, dy and the states),
    dx is the slabs' side by side, and what sums over P is each slab's part
    added in the kernel's order: ddt over the slabs in turn, dB and dC each
    head's slabs in turn within the group's heads in order, and dA and dD's
    per-chunk parts by ``ssd_sum_slabs``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk, product=product)
    states_in, _ = ssd_state_passing(states, cum, chunk=chunk)
    dstates = ssd_state_passing_bwd(
        ssd_chunk_dstate(dy, Cm, cum, chunk=chunk, product=product), cum,
        d_state, chunk=chunk)
    width = P if slab is None else slab
    parts = [ssd_chunk_scan_bwd(
        x[..., p:p + width], dt, A, Bm, Cm, D, dy[..., p:p + width], cum,
        states_in[..., p:p + width, :], dstates[..., p:p + width, :],
        chunk=chunk, product=product) for p in range(0, P, width)]
    dx = torch.cat([part[0] for part in parts], -1)
    ddt = parts[0][1]
    for part in parts[1:]:
        ddt = ddt + part[1]

    def by_group(ts):    # each slab's (B,S,H,N) -> (B,S,G,N), in the order
        t = torch.stack(ts, 3).reshape(B, S, G, H // G * len(ts), N)
        out = t[:, :, :, 0]
        for k in range(1, t.shape[3]):
            out = out + t[:, :, :, k]
        return out
    return (dx.to(x.dtype), ddt.to(dt.dtype),
            ssd_sum_slabs([part[4] for part in parts]).to(A.dtype),
            by_group([part[2] for part in parts]).to(Bm.dtype),
            by_group([part[3] for part in parts]).to(Cm.dtype),
            ssd_sum_slabs([part[5] for part in parts]).to(D.dtype))


def ssd_decode_step(state, x, dt, A, Bm, Cm, D):
    """Single-token decode: state (B,H,P,N), x (B,H,P), dt (B,H),
    Bm/Cm (B,G,N) -> (new_state fp32, y (B,H,P) in ``x.dtype``)."""
    H = x.shape[1]
    f32 = torch.float32
    Bh = _expand_groups(Bm.to(f32)[:, None], H)[:, 0]
    Ch = _expand_groups(Cm.to(f32)[:, None], H)[:, 0]
    dtf = dt.to(f32)
    a = torch.exp(dtf * A.to(f32))
    state = state * a[..., None, None] + (
        (dtf[..., None] * x.to(f32))[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + x.to(f32) * D.to(f32)[None, :, None]
    return state, y.to(x.dtype)

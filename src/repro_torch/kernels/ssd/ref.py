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
"""
from __future__ import annotations

import torch


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


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) -> (B, nc, chunk, ...), the last chunk padded with 0."""
    B, S = t.shape[:2]
    nc = -(-S // chunk)
    pad = torch.zeros((B, nc * chunk - S, *t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad], 1).reshape(B, nc, chunk, *t.shape[2:])


def ssd_chunk_state(x, dt, A, Bm, *, chunk: int = 128, round_operand=None):
    """Phase 1: (states (B,nc,H,P,N) fp32, cum (B,H,nc·chunk) fp32).

    cum is the within-chunk inclusive cumsum of dt·A; states[:, c] is the
    state chunk c leaves from a zero state, sum_j exp(total - cum_j) dt_j
    x_j B_jᵀ.  ``round_operand`` (None: exact fp32) is applied to the fp32
    operand w∘x, as the kernel rounds it for the tensor cores."""
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
    states = torch.einsum("bcqhp,bcqhn->bchpn", wx, Bh)
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
                   round_operand=None):
    """Phase 3: y (B,S,H,P) in ``x.dtype``: the intra-chunk term
    (C·Bᵀ ∘ L ∘ dt_j)·x, the inter-chunk term exp(cum_i) C·state_in and
    the D skip, rounded once.  ``round_operand`` (None: exact fp32) is
    applied to the fp32 operands the kernel rounds for the tensor cores:
    the scores and the state entering the chunk."""
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
    cb = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)
    scores = cb * torch.exp(arg) * dtf[:, :, None]          # (B,nc,Q,Q,H)
    if round_operand is not None:
        scores = round_operand(scores)
        states_in = round_operand(states_in)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xf)
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(cum), Ch,
                           states_in)
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

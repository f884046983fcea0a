"""Plain PyTorch Mamba-2 SSD (state-space duality) scan: the CPU path and the
oracle for the CUDA kernel.

Two scans of one function:

* ``ssd_sequential``: the exact recurrence, one timestep at a time (the
  ground truth, and the CPU path when S is not a multiple of the chunk).
* ``ssd_chunked``: the SSD chunked decomposition (intra-chunk quadratic term
  plus inter-chunk state passing), the algorithm the CUDA kernel implements.

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


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """The SSD algorithm: O(S·chunk) intra-chunk + O(S/chunk) state pass."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(B, nc, chunk, H, P)
    dtf = dt.to(f32).reshape(B, nc, chunk, H)
    Bh = _expand_groups(Bm.to(f32), H).reshape(B, nc, chunk, H, N)
    Ch = _expand_groups(Cm.to(f32), H).reshape(B, nc, chunk, H, N)

    dA = dtf * A.to(f32)                          # (B,nc,Q,H) log-decay
    cum = torch.cumsum(dA, dim=2)                 # inclusive cumulative
    total = cum[:, :, -1:]                        # (B,nc,1,H)

    # intra-chunk quadratic term: att[i,j] = exp(cum_i - cum_j) for i >= j.
    # The argument is masked BEFORE the exp: masking the exp's output leaves
    # exp(+big) = inf on the dead branch, whose gradient is inf * 0 = NaN.
    li = cum[:, :, :, None, :]                    # (B,nc,Q,1,H)
    lj = cum[:, :, None, :, :]                    # (B,nc,1,Q,H)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    arg = torch.where(causal[None, None, :, :, None], li - lj,
                      torch.tensor(-1e30, dtype=f32, device=x.device))
    att = torch.exp(arg)                          # (B,nc,Q,Q,H)
    cb = torch.einsum("bcqhn,bcshn->bcqsh", Ch, Bh)
    y_intra = torch.einsum("bcqsh,bcqsh,bcsh,bcshp->bcqhp",
                           cb, att, dtf, xf)

    # per-chunk end state: sum_j exp(total - cum_j) * dt_j * B_j x_j
    decay_to_end = torch.exp(total - cum)         # (B,nc,Q,H)
    chunk_state = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchpn",
                               decay_to_end, dtf, Bh, xf)

    # inter-chunk recurrence over nc chunks
    state = torch.zeros((B, H, P, N), dtype=f32, device=x.device)
    states_in = torch.empty((B, nc, H, P, N), dtype=f32, device=x.device)
    for c in range(nc):
        states_in[:, c] = state                   # state entering the chunk
        state = (state * torch.exp(total[:, c, 0])[..., None, None]
                 + chunk_state[:, c])

    # inter-chunk contribution: C_i exp(cum_i) state_in
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp",
                           torch.exp(cum), Ch, states_in)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(x.dtype), state


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

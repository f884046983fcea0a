"""Plain PyTorch RG-LRU (Real-Gated Linear Recurrent Unit): the CPU path
and the oracle for the CUDA scan kernel.

Griffin / RecurrentGemma (arXiv:2402.19427):

    r_t = sigmoid(gate_a(x_t))               recurrence gate
    i_t = sigmoid(gate_x(x_t))               input gate
    log a_t = -c * softplus(Λ) * r_t         (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The gates are block-diagonal linear maps (num_heads blocks), computed by
``rglru_gates``; the scan takes per-step log-decay ``log_a`` and gated input
``gx``:

    h_t = exp(log_a_t) ⊙ h_{t-1} + sqrt(1 - exp(2 log_a_t)) ⊙ gx_t

Two scans of one function: ``rglru_sequential`` (one step at a time, the
oracle, and the CPU path below 64 steps) and ``rglru_assoc`` (a log-depth
associative scan of the (a, u) pairs, the CPU path from 64 steps on, as in
the JAX package).

``rglru_bwd`` is the plain backward of the scan (the oracle for the CUDA
backward kernel; on the CPU path autograd differentiates the forward), and
``rglru_bwd_segmented`` the same function in the segmented backward body's
order of composition (its model, held against JAX in the tests).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rglru_sequential(log_a: torch.Tensor, gx: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_S (B,W) fp32).

    fp32 internals, one step at a time."""
    B, S, W = gx.shape
    la = log_a.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=1e-12))
    u = beta * gx.float()
    a = torch.exp(la)
    h = (torch.zeros((B, W), dtype=torch.float32, device=gx.device)
         if h0 is None else h0.float())
    ys = torch.empty((B, S, W), dtype=torch.float32, device=gx.device)
    for t in range(S):
        h = a[:, t] * h + u[:, t]
        ys[:, t] = h
    return ys.to(gx.dtype), h


def rglru_assoc(log_a: torch.Tensor, gx: torch.Tensor,
                h0: torch.Tensor | None = None):
    """``rglru_sequential``'s function by a log-depth associative scan of
    the pairs (a_t, u_t) under (a1, u1) ∘ (a2, u2) = (a1 a2, u1 a2 + u2),
    with h0 folded in as a virtual step 0 (a = 1, u = h0).

    log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_S (B,W) fp32)."""
    la = log_a.float()
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=1e-12)) \
        * gx.float()
    a = torch.exp(la)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], 1)
        u = torch.cat([h0.float()[:, None], u], 1)
    # Hillis-Steele: after the pass with offset d, step t holds the
    # composition of steps max(0, t - 2d + 1) .. t
    d = 1
    while d < u.shape[1]:
        u = torch.cat([u[:, :d], u[:, :-d] * a[:, d:] + u[:, d:]], 1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], 1)
        d *= 2
    if h0 is not None:
        u = u[:, 1:]
    return u.to(gx.dtype), u[:, -1]


def rglru_bwd(log_a: torch.Tensor, gx: torch.Tensor, dy: torch.Tensor,
              h0: torch.Tensor | None = None,
              dh_last: torch.Tensor | None = None):
    """The gradients (d log_a, d gx, dh0) of the scan's y and h_last, given
    dy (B,S,W) and ``dh_last`` (B,W) or None (h_last unused); d log_a and
    d gx in their inputs' dtypes, dh0 fp32 (None without h0).

    h is recomputed in fp32, one step at a time, and walked in reverse:
    dh_t = dy_t + a_{t+1} dh_{t+1} (from dh_last, or 0), d gx_t = β_t dh_t,
    d log_a_t = dh_t (a_t h_{t-1} - gx_t exp(2 log_a_t) / β_t), dh0 =
    a_1 dh_1, with a = exp(log_a) and β = sqrt(max(1 - exp(2 log_a),
    1e-12)).  Where the clamp holds β at its floor, β has no gradient (as
    autograd of the forward gives it)."""
    la = log_a.float()
    x = gx.float()
    e2 = torch.exp(2.0 * la)
    v = 1.0 - e2
    beta = torch.sqrt(torch.clamp(v, min=1e-12))
    dbeta = torch.where(v >= 1e-12, -e2 / beta, torch.zeros_like(v))
    a = torch.exp(la)
    u = beta * x
    B, S, W = gx.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=gx.device)
         if h0 is None else h0.float())
    h_prev = torch.empty((B, S, W), dtype=torch.float32, device=gx.device)
    for t in range(S):
        h_prev[:, t] = h
        h = a[:, t] * h + u[:, t]
    carry = (torch.zeros((B, W), dtype=torch.float32, device=gx.device)
             if dh_last is None else dh_last.float())
    dy = dy.float()
    dla = torch.empty((B, S, W), dtype=torch.float32, device=gx.device)
    dgx = torch.empty_like(dla)
    for t in reversed(range(S)):
        g = dy[:, t] + carry
        dgx[:, t] = beta[:, t] * g
        dla[:, t] = g * (a[:, t] * h_prev[:, t] + x[:, t] * dbeta[:, t])
        carry = a[:, t] * g
    return (dla.to(log_a.dtype), dgx.to(gx.dtype),
            None if h0 is None else carry)


def rglru_bwd_segmented(log_a: torch.Tensor, gx: torch.Tensor,
                        dy: torch.Tensor, h0: torch.Tensor | None = None,
                        dh_last: torch.Tensor | None = None, *,
                        steps: int = 32, segments: int = 16):
    """``rglru_bwd``'s function, composed as the CUDA backward's segmented
    body composes it (csrc/rglru.cu): time in windows of ``segments`` x
    ``steps`` steps (identity steps past S), each segment composed forward
    into (A = prod a, U = h from 0) and backward into (A, V = the carry
    c_{t-1} = a_t (dy_t + c_t) leaving its first step from 0, summed
    forward as sum_t (prod_{s <= t} a_s) dy_t).  The states
    entering the windows come from a forward walk over the windows' pairs;
    then the windows, last first: each segment's entry state from the pairs
    before it, its carry from the pairs after it (last first, from dh_last or
    the later window's carry), a forward walk for a_t h_{t-1} + gx_t dβ_t and
    a reverse walk for d gx and d log_a.  Returns what ``rglru_bwd``
    returns."""
    B, S, W = gx.shape
    win = steps * segments
    nwin = -(-S // win)
    pad = nwin * win - S
    la, x, g = (F.pad(t.float(), (0, 0, 0, pad)).view(B, nwin, segments,
                                                      steps, W)
                for t in (log_a, gx, dy))
    e2 = torch.exp(2.0 * la)
    v = 1.0 - e2
    beta = torch.sqrt(torch.clamp(v, min=1e-12))
    dbeta = torch.where(v >= 1e-12, -e2 / beta, torch.zeros_like(v))
    a = torch.exp(la)
    u = beta * x
    A = torch.ones_like(a[..., 0, :])           # (B, nwin, segments, W)
    U, V = torch.zeros_like(A), torch.zeros_like(A)
    for i in range(steps):
        U = a[..., i, :] * U + u[..., i, :]
        A = A * a[..., i, :]
        V = V + A * g[..., i, :]
    h = (torch.zeros((B, W), dtype=torch.float32, device=gx.device)
         if h0 is None else h0.float())
    h_win = []
    for w in range(nwin):
        h_win.append(h)
        for j in range(segments):
            h = A[:, w, j] * h + U[:, w, j]
    c = (torch.zeros((B, W), dtype=torch.float32, device=gx.device)
         if dh_last is None else dh_last.float())
    dla, dgx = torch.empty_like(a), torch.empty_like(a)
    for w in reversed(range(nwin)):
        hs, h = [], h_win[w]
        for j in range(segments):
            hs.append(h)
            h = A[:, w, j] * h + U[:, w, j]
        cs = [None] * segments
        for j in reversed(range(segments)):
            cs[j] = c
            c = A[:, w, j] * c + V[:, w, j]
        h, c = torch.stack(hs, 1), torch.stack(cs, 1)   # (B, segments, W)
        q = torch.empty_like(a[:, w])
        for i in range(steps):
            q[..., i, :] = a[:, w, :, i] * h + x[:, w, :, i] * dbeta[:, w, :, i]
            h = a[:, w, :, i] * h + u[:, w, :, i]
        for i in reversed(range(steps)):
            gt = g[:, w, :, i] + c
            dgx[:, w, :, i] = beta[:, w, :, i] * gt
            dla[:, w, :, i] = gt * q[..., i, :]
            c = a[:, w, :, i] * gt
        c = c[:, 0]          # the carry leaving the window's first step
    dla, dgx = (t.reshape(B, nwin * win, W)[:, :S] for t in (dla, dgx))
    return (dla.to(log_a.dtype), dgx.to(gx.dtype),
            None if h0 is None else c)


def rglru_gates(x: torch.Tensor, p: dict, *, c: float = 8.0):
    """(log_a, gx), both fp32, from inputs and block-diagonal gate params.

    x (B,S,W); p = {a_gate_w (Hb, bw, bw), a_gate_b (Hb, bw),
                    x_gate_w, x_gate_b, a_param (W,)} with W = Hb*bw."""
    B, S, W = x.shape
    Hb, bw, _ = p["a_gate_w"].shape
    xb = x.reshape(B, S, Hb, bw).float()
    ra = torch.sigmoid(torch.einsum("bshi,hij->bshj", xb,
                                    p["a_gate_w"].float())
                       + p["a_gate_b"].float())
    ix = torch.sigmoid(torch.einsum("bshi,hij->bshj", xb,
                                    p["x_gate_w"].float())
                       + p["x_gate_b"].float())
    log_a_base = -c * F.softplus(p["a_param"].float())  # (W,)
    log_a = ra.reshape(B, S, W) * log_a_base
    gx = ix.reshape(B, S, W) * x.float()
    return log_a, gx

"""Mamba2 (State-Space Duality) blocks [arXiv:2405.21060] (port of
``repro/models/ssm.py``).

Sequence mode (prefill) runs the chunked SSD scan: inside a chunk the
1-semiseparable masked "attention" form, between chunks a state recurrence
(the reference's ``lax.scan`` over chunks is a Python loop here). Decode
is the constant-time one-token recurrence. There is no Pallas kernel in the
reference: every product is plain PyTorch, as it is plain JAX there.

Dtypes are the reference's: the projections and the depthwise conv run in
the model dtype, the SSD math and the carried state in float32. The cache
``{"conv": (B, K-1, conv_dim), "state": (B, H, P, N) fp32}`` is written IN
PLACE (the reference returns a new one); a decode's ``row_mask`` keeps a
frozen row's conv window and state as they were (the reference's generic
``gate`` in ``transformer._apply_layer``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm


def d_inner_of(cfg) -> int:
    return cfg.ssm.expand * cfg.d_model


def n_heads_of(cfg) -> int:
    return d_inner_of(cfg) // cfg.ssm.head_dim


def conv_dim_of(cfg) -> int:
    return d_inner_of(cfg) + 2 * cfg.ssm.n_groups * cfg.ssm.d_state


def init_mamba(n: int, cfg, dtype, device, gen) -> dict:
    """The reference's ``init_mamba`` leaves at its shapes, scales and
    dtypes, stacked over ``n`` layers (seeded from ``gen``; ``A_log``,
    ``D`` and ``dt_bias`` are the reference's fixed values)."""
    s = cfg.ssm
    d, di, h, cdim = cfg.d_model, d_inner_of(cfg), n_heads_of(cfg), \
        conv_dim_of(cfg)
    in_dim = 2 * di + 2 * s.n_groups * s.d_state + h

    def normal(shape, scale):
        return torch.randn((n,) + shape, dtype=dtype, device=device,
                           generator=gen).mul_(scale)

    def fixed(t):
        return t.to(device).expand((n,) + t.shape).clone()
    return {
        "in_proj": normal((d, in_dim), d ** -0.5),
        "conv_w": normal((s.conv_kernel, cdim), 0.3),
        "conv_b": torch.zeros((n, cdim), dtype=dtype, device=device),
        "A_log": fixed(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": torch.ones((n, h), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((n, h), dtype=torch.float32, device=device),
        "norm": torch.zeros((n, di), dtype=dtype, device=device),
        "out_proj": normal((di, d), di ** -0.5),
    }


def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim_of(cfg)),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads_of(cfg), s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------------------
# Depthwise causal conv
# ---------------------------------------------------------------------------

def _conv_scan(w, b, x, init_state):
    """Causal depthwise conv1d. x: (B, S, C); init_state: (B, K-1, C).
    Returns (silu(conv + b), the last K-1 inputs: the next window)."""
    k = w.shape[0]
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = 0
    for i in range(k):            # the reference's sum, in its order
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return F.silu(out + b), xp[:, xp.shape[1] - (k - 1):]


# ---------------------------------------------------------------------------
# Chunked SSD
# ---------------------------------------------------------------------------

def _expand_groups(m, h: int):
    """(B, S, G, N) -> (B, S, H, N), each group repeated H/G times."""
    g = m.shape[2]
    if g == h:
        return m
    return torch.repeat_interleave(m, h // g, dim=2)


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, init_state=None):
    """SSD scan. x: (B,S,H,P); dt: (B,S,H); a: (H,) negative;
    b_mat/c_mat: (B,S,G,N). Returns (y (B,S,H,P) fp32, final_state
    (B,H,P,N) fp32). A sequence that is not a multiple of the chunk is
    zero-padded at its end, as in the reference (dt = 0 there, so the pad
    leaves the state as it was)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    bh = _expand_groups(b_mat, h).float()
    ch = _expand_groups(c_mat, h).float()
    xdt_all = x.float() * dt[..., None]
    da_all = (dt * a).float()                             # dA, negative
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        xdt, da, bc, cc = xdt_all[:, sl], da_all[:, sl], bh[:, sl], ch[:, sl]
        cum = torch.cumsum(da, dim=1)                     # (B,Q,H)
        # Intra-chunk 1-SS mask L[q1, q2] = exp(cum_q1 - cum_q2); masked
        # BEFORE exp (the upper triangle is positive and would overflow).
        rel = cum[:, :, None, :] - cum[:, None, :, :]     # (B,Q,Q,H)
        l_mask = torch.exp(torch.where(tri, rel, -torch.inf))
        scores = torch.einsum("bqhn,bkhn->bqkh", cc, bc) * l_mask
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xdt)
        # The carried state's contribution.
        y = y + torch.einsum("bqhn,bhpn,bqh->bqhp", cc, state, torch.exp(cum))
        decay_end = torch.exp(cum[:, -1:, :] - cum)       # (B,Q,H)
        new_state = torch.einsum("bkhn,bkh,bkhp->bhpn", bc, decay_end, xdt)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + new_state
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, state


def ssd_decode_step(x, dt, a, b_mat, c_mat, state):
    """One-token recurrence. x: (B,H,P); dt: (B,H); b/c: (B,G,N);
    state: (B,H,P,N) fp32. Returns (y (B,H,P), new_state)."""
    h = x.shape[1]
    bh = _expand_groups(b_mat[:, None], h)[:, 0]           # (B,H,N)
    ch = _expand_groups(c_mat[:, None], h)[:, 0]
    da = torch.exp((dt * a).float())                       # (B,H)
    xdt = (x * dt[..., None]).float()
    state = state * da[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt, bh.float())
    y = torch.einsum("bhn,bhpn->bhp", ch.float(), state)
    return y, state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    di = d_inner_of(cfg)
    gn = s.n_groups * s.d_state
    return zxbcdt.split([di, di + 2 * gn, n_heads_of(cfg)], dim=-1)


def _gated_out(p, y, z, cfg, dtype):
    y = rmsnorm(p["norm"], y.to(dtype) * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"]


def mamba_block(p, x, cfg, cache=None):
    """Mamba2 block, sequence mode (prefill). x: (B, S, d) -> (B, S, d).

    With ``cache`` the conv window and the SSD state start from the
    cache's and the final ones are written back into it in place, so a
    chunked continuation is the same code as a fresh prefill (whose cache
    is zero)."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    di, h = d_inner_of(cfg), n_heads_of(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    conv_init = (cache["conv"] if cache is not None else torch.zeros(
        (bsz, s.conv_kernel - 1, xbc.shape[-1]), dtype=x.dtype,
        device=x.device))
    xbc, conv_state = _conv_scan(p["conv_w"], p["conv_b"], xbc, conv_init)
    xin, bmat, cmat = xbc.split([di, gn, gn], dim=-1)
    xin = xin.reshape(bsz, seq, h, s.head_dim)
    bmat = bmat.reshape(bsz, seq, s.n_groups, s.d_state)
    cmat = cmat.reshape(bsz, seq, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    init_state = cache["state"] if cache is not None else None
    y, state = ssd_chunked(xin, dt, a, bmat, cmat, s.chunk, init_state)
    y = y + p["D"][None, None, :, None] * xin.float()
    out = _gated_out(p, y.reshape(bsz, seq, di), z, cfg, x.dtype)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
    return out


def mamba_decode(p, x, cfg, cache, row_mask=None):
    """Mamba2 block, one-token decode. x: (B, 1, d) -> (B, 1, d); the
    cache's conv window and state advance in place, except on rows where
    ``row_mask`` ((B,) bool) is False, which keep theirs."""
    s = cfg.ssm
    bsz = x.shape[0]
    di, h = d_inner_of(cfg), n_heads_of(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt_raw = _split_proj(cfg, x[:, 0] @ p["in_proj"])
    window = torch.cat([cache["conv"].to(x.dtype), xbc[:, None]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv_out)
    xin, bmat, cmat = xbc.split([di, gn, gn], dim=-1)
    xin = xin.reshape(bsz, h, s.head_dim)
    bmat = bmat.reshape(bsz, s.n_groups, s.d_state)
    cmat = cmat.reshape(bsz, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(xin.float(), dt, a, bmat, cmat,
                               cache["state"])
    y = y + p["D"][None, :, None] * xin.float()
    out = _gated_out(p, y.reshape(bsz, di), z, cfg, x.dtype)[:, None]
    new_conv = window[:, 1:]
    if row_mask is not None:
        new_conv = torch.where(row_mask[:, None, None], new_conv,
                               cache["conv"])
        state = torch.where(row_mask[:, None, None, None], state,
                            cache["state"])
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(state)
    return out

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

On a mesh (``pc.mesh``) the same block runs as the rank program over
this rank's leaves and cache shards.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm, row_parallel, tp_splits


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
#
# One body serves one card and the mesh layout of ``sharding.rules``
# (``pc.mesh``: the rank program over this rank's leaves and cache
# shards). On a mesh each leaf and cache shard lies where the rules put
# it, each only where ``model`` divides its dim (else whole on every
# rank): ``in_proj`` by its fused columns [z | xBC | dt],
# ``conv_w``/``conv_b`` and the conv window by the conv channels [x | B |
# C], ``out_proj`` by its d_inner rows, the SSM state by its heads. The
# three splits do not line up (a rank's in_proj columns straddle z and
# xBC; its conv channels are not its heads' x), so a rank gathers the
# projection over ``model``, convolves its channels and gathers them,
# scans its heads (x and dt of its heads, B and C of their groups) from
# its state shard, norms its d_inner rows with the sum of squares summed
# over ``model``, and projects them out row-parallel
# (``layers.row_parallel``). Without a mesh every block is the whole dim
# and no collective runs.

def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    di = d_inner_of(cfg)
    gn = s.n_groups * s.d_state
    return zxbcdt.split([di, di + 2 * gn, n_heads_of(cfg)], dim=-1)


def _block_of(pc, n: int):
    """(start, size) of this rank's block of a dim of ``n`` that the rules
    split over ``model``; (0, n) when they keep it whole."""
    if tp_splits(pc, n):
        k = n // pc.tp
        return pc.mesh.axis_index(pc.model_axis) * k, k
    return 0, n


def _gathered(pc, local, n: int):
    """The whole last dim of ``n`` from this rank's block of it."""
    if local.shape[-1] == n:
        return local
    return pc.mesh.all_gather(local, -1, pc.model_axis)


def _groups_of(m, h0: int, hq: int, h: int):
    """B or C (..., G, N) for heads [h0, h0 + hq) of ``h``: as it is when
    the scan's own expansion maps them right (one group, or every head),
    else each head's group (..., hq, N)."""
    g = m.shape[-2]
    if g == 1 or hq == h:
        return m
    idx = torch.arange(h0, h0 + hq, device=m.device) // (h // g)
    return m.index_select(-2, idx)


def _proj_in(p, x, cfg, pc):
    """The projection, gathered over ``model``, split: (z, this rank's
    conv channels of xBC, dt_raw of its heads, the head block (h0,
    hq))."""
    h, cdim = n_heads_of(cfg), conv_dim_of(cfg)
    zxbcdt = _gathered(pc, x @ p["in_proj"], d_inner_of(cfg) + cdim + h)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    c0, cl = _block_of(pc, cdim)
    h0, hq = _block_of(pc, h)
    return z, xbc[..., c0:c0 + cl], dt_raw[..., h0:h0 + hq], (h0, hq)


def _heads_in(p, xbc, cfg, h0: int, hq: int):
    """From the gathered conv output (..., conv_dim): x of heads [h0, h0 +
    hq) (..., hq, P), B and C (``_groups_of``), and the heads' A, D and
    dt_bias."""
    s = cfg.ssm
    di, h = d_inner_of(cfg), n_heads_of(cfg)
    gn = s.n_groups * s.d_state
    lead = xbc.shape[:-1]
    xin = xbc[..., h0 * s.head_dim:(h0 + hq) * s.head_dim].reshape(
        lead + (hq, s.head_dim))
    bmat = xbc[..., di:di + gn].reshape(lead + (s.n_groups, s.d_state))
    cmat = xbc[..., di + gn:].reshape(lead + (s.n_groups, s.d_state))
    sl = slice(h0, h0 + hq)
    return (xin, _groups_of(bmat, h0, hq, h), _groups_of(cmat, h0, hq, h),
            -torch.exp(p["A_log"][sl]), p["D"][sl], p["dt_bias"][sl])


def _gated_out(p, y, z, cfg, pc, dtype, h0: int, hq: int):
    """The gated RMS norm and ``out_proj`` over heads [h0, h0 + hq)'s
    d_inner rows (y (..., hq * P) fp32): on a mesh whose heads split, the
    norm's sum of squares is summed over ``model`` and ``out_proj`` is
    this rank's row shard, summed over ``model`` (whole when d_inner does
    not split, and then neither do the heads)."""
    di, hd = d_inner_of(cfg), cfg.ssm.head_dim
    r0, rn = h0 * hd, hq * hd
    g = y.to(dtype) * F.silu(z[..., r0:r0 + rn])
    if rn == di:
        g = rmsnorm(p["norm"], g, cfg.norm_eps)
    else:
        g = g.float()
        ss = pc.mesh.all_reduce((g * g).sum(dim=-1, keepdim=True),
                                pc.model_axis)
        g = (g * torch.rsqrt(ss / di + cfg.norm_eps)
             * (1.0 + p["norm"][r0:r0 + rn].float())).to(dtype)
    if not tp_splits(pc, di):
        return g @ p["out_proj"]
    if rn == di:
        o0, on = _block_of(pc, di)
        g = g[..., o0:o0 + on]
    return row_parallel(g, p["out_proj"], pc)


def mamba_block(p, x, cfg, cache=None, pc=None):
    """Mamba2 block, sequence mode (prefill). x: (B, S, d) -> (B, S, d).

    With ``cache`` the conv window and the SSD state start from the
    cache's and the final ones are written back into it in place, so a
    chunked continuation is the same code as a fresh prefill (whose cache
    is zero). ``pc`` with a mesh: the rank program; x is this rank's rows,
    the same on every ``model`` rank, and ``cache`` this rank's shards
    (its conv channels' window (B, K-1, conv_dim / m), its heads' state
    (B, H / m, P, N))."""
    s = cfg.ssm
    bsz, seq, _ = x.shape
    z, xbc, dt_raw, (h0, hq) = _proj_in(p, x, cfg, pc)
    conv_init = (cache["conv"] if cache is not None else torch.zeros(
        (bsz, s.conv_kernel - 1, xbc.shape[-1]), dtype=x.dtype,
        device=x.device))
    xbc, conv_state = _conv_scan(p["conv_w"], p["conv_b"], xbc, conv_init)
    xbc = _gathered(pc, xbc, conv_dim_of(cfg))
    xin, bmat, cmat, a, d_skip, dt_bias = _heads_in(p, xbc, cfg, h0, hq)
    dt = F.softplus(dt_raw.float() + dt_bias)
    init_state = cache["state"] if cache is not None else None
    y, state = ssd_chunked(xin, dt, a, bmat, cmat, s.chunk, init_state)
    y = y + d_skip[None, None, :, None] * xin.float()
    out = _gated_out(p, y.reshape(bsz, seq, hq * s.head_dim), z, cfg, pc,
                     x.dtype, h0, hq)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(state)
    return out


def mamba_decode(p, x, cfg, cache, row_mask=None, pc=None):
    """Mamba2 block, one-token decode. x: (B, 1, d) -> (B, 1, d); the
    cache's conv window and state advance in place, except on rows where
    ``row_mask`` ((B,) bool) is False, which keep theirs. ``pc`` with a
    mesh: the rank program over this rank's leaves and cache shards, as
    in ``mamba_block``."""
    s = cfg.ssm
    bsz = x.shape[0]
    z, xbc, dt_raw, (h0, hq) = _proj_in(p, x[:, 0], cfg, pc)
    window = torch.cat([cache["conv"].to(x.dtype), xbc[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                 + p["conv_b"])
    xbc = _gathered(pc, xbc, conv_dim_of(cfg))
    xin, bmat, cmat, a, d_skip, dt_bias = _heads_in(p, xbc, cfg, h0, hq)
    dt = F.softplus(dt_raw.float() + dt_bias)
    y, state = ssd_decode_step(xin.float(), dt, a, bmat, cmat,
                               cache["state"])
    y = y + d_skip[None, :, None] * xin.float()
    out = _gated_out(p, y.reshape(bsz, hq * s.head_dim), z, cfg, pc,
                     x.dtype, h0, hq)[:, None]
    new_conv = window[:, 1:]
    if row_mask is not None:
        new_conv = torch.where(row_mask[:, None, None], new_conv,
                               cache["conv"])
        state = torch.where(row_mask[:, None, None, None], state,
                            cache["state"])
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(state)
    return out

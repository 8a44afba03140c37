"""Plain PyTorch versions of the two kernels (port of ``repro/kernels/ref.py``).

They are what a CPU tensor runs, the oracle ``chip_smoke.py`` holds each
CUDA kernel against on the card, and what the CPU tests compare with the
JAX reference. ``preferred_element_type=float32`` in the reference becomes
an explicit upcast to float32 before each product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def act_fn(act: str):
    """swiglu -> silu; geglu -> tanh-approximated gelu (``jax.nn.gelu``'s
    default, which torch's default exact gelu is not)."""
    if act == "geglu":
        return lambda h: F.gelu(h, approximate="tanh")
    return F.silu


def moe_ffn_ref(x, w_gate, w_up, w_down, act: str = "swiglu",
                group_sizes=None):
    """Grouped expert FFN over capacity buckets.

    x: (E, C, d); w_gate/w_up: (E, d, f); w_down: (E, f, d) -> (E, C, d).
    ``group_sizes``: optional (E,) real-row counts; rows at or past a
    group's fill level are zero.
    """
    x32 = x.float()
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", x32, w_gate.float()))
    h = h * torch.einsum("ecd,edf->ecf", x32, w_up.float())
    y = torch.einsum("ecf,efd->ecd", h.to(x.dtype).float(), w_down.float())
    if group_sizes is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < group_sizes.to(x.device)[:, None])
        y = torch.where(live[..., None], y, 0.0)
    return y.to(x.dtype)


def decode_attn_ref(q, k, v, valid_len, return_lse: bool = False):
    """Single-query GQA decode attention.

    q: (B, H, D); k/v: (B, S, Hkv, D); valid_len: (B,) int -> (B, H, D);
    with ``return_lse`` also the (B, H) fp32 log-sum-exp of each row's
    scaled scores over positions < valid_len (-inf for a row with none).
    """
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * d ** -0.5
    mask = (torch.arange(s, device=q.device)[None]
            < valid_len.to(q.device)[:, None])                     # (B, S)
    live = torch.where(mask[:, None, None], scores, -torch.inf)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype).float(), v.float())
    out = out.reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(live, dim=-1).reshape(b, h)

"""Plain PyTorch reference of the served decoders: GQA or MLA attention,
dense or MoE FFN layers, in float32 (TF32 off), one full causal forward
pass over each whole sequence, with no cache, batching, padding rule or
kernel.

It computes the function the configuration file states under ``port``
(the published model with the departures its file lists): the embedding
scaled by sqrt(d_model); RMSNorm with a (1 + w) scale; RoPE on the two
halves of each rotated head (theta from the file); GQA, head h using kv
head h // (H / Hkv); MLA in its direct form (the latent normed, the rope
key shared by the heads, scale 1 / sqrt(nope + rope)); a SwiGLU FFN; an
MoE layer routing each token to its top-k experts by softmax or sigmoid
scores of an fp32 router, the k gates normalised to sum 1, every token
kept (the file's capacity factor drops none), plus the shared expert; a
final RMSNorm and the LM head, logits over the unpadded vocabulary.

The weights are the benchmark's tree (``perfbench.weights``), in the
layout the program takes: ``segments`` of layer stacks, dense layers
first. ``precision`` other than "fp32" computes the function as a
program that holds its activations in that type does: every activation
kept between operations (each product's input and output, the residual
stream after each add, the embedding) is rounded to it, and each weight
too; the router, the norms, RoPE and attention's scores and softmax run
in float32 on the rounded values, as the program runs them.
``precision="bf16"`` is the witness (``calibrate.py --witness``), an
independent bf16 computation that tells a program's fault from a model's
own sensitivity to rounding. ``precision="fp8"`` is the control: the
same held in float8 e4m3 with an absmax scale, per row for an activation
and per output column for a weight, one step below the bf16 that the
configurations state.
"""

from __future__ import annotations

import math

import torch

F8_MAX = 448.0                 # largest finite float8 e4m3fn
QUERY_BLOCK = 1024             # queries a block of causal attention


def _fp8(t, dim: int):
    """``t`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim`` (returned as float32)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = F8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Decoder:
    """``logits(seqs, positions)``: per sequence (1-D int64 token ids on the
    weights' device), the (len(positions), vocab) float32 logits at those
    positions of one causal forward pass over the whole sequence."""

    def __init__(self, port: dict, params: dict, precision: str = "fp32"):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32, bf16 or fp8")
        self.port = port
        self.p = params
        self.precision = precision
        moe = port.get("moe")
        n = port["n_layers"]
        if moe and moe.get("first_dense_layers", 0):
            k = moe["first_dense_layers"]
            self.segments = [("D", k), ("E", n - k)]
        elif moe:
            self.segments = [("E", n)]
        else:
            self.segments = [("G", n)]

    # -- primitives -------------------------------------------------------
    def act(self, t):
        """An activation as the precision holds it between operations."""
        if self.precision == "fp8":
            return _fp8(t, -1)
        if self.precision == "bf16":
            return t.to(torch.bfloat16).float()
        return t

    def lin(self, x, w):
        """x (T, in) float32 times w (..., in, out-dims) as (in, out)."""
        w2 = w.reshape(x.shape[-1], -1).float()
        if self.precision == "fp8":
            w2 = _fp8(w2, 0)
        return self.act(self.act(x) @ w2)

    def norm(self, w, x):
        eps = self.port.get("norm_eps", 1e-6)
        y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
        return self.act(y * (1.0 + w.float()))

    def rope(self, x, pos):
        """x (S, H, D), pos (S,): the two halves rotated."""
        d = x.shape[-1]
        theta = float(self.port.get("rope_theta", 10000.0))
        freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                              device=x.device) / d))
        ang = (pos.float()[:, None] * freqs)[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def attend(self, q, k, v, scale):
        """Causal attention. q, k (S, H, Dqk); v (S, H, Dv) -> (S, H, Dv),
        in blocks of queries."""
        s = q.shape[0]
        out = torch.empty(q.shape[:2] + (v.shape[-1],), device=q.device)
        keys = torch.arange(s, device=q.device)
        for a in range(0, s, QUERY_BLOCK):
            b = min(s, a + QUERY_BLOCK)
            sc = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
            mask = keys[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
            sc = torch.where(mask[None], sc, -torch.inf)
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                    v[:b])
        return out

    def ffn(self, p, x):
        h = torch.nn.functional.silu(self.lin(x, p["w_gate"]))
        return self.lin(h * self.lin(x, p["w_up"]), p["w_down"])

    # -- layers -----------------------------------------------------------
    def gqa(self, p, x, pos):
        port = self.port
        s, h, hkv, hd = x.shape[0], port["n_heads"], port["n_kv_heads"], \
            port["head_dim"]
        q = self.rope(self.lin(x, p["wq"]).view(s, h, hd), pos)
        k = self.rope(self.lin(x, p["wk"]).view(s, hkv, hd), pos)
        v = self.lin(x, p["wv"]).view(s, hkv, hd)
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        out = self.attend(q, k, v, hd ** -0.5)
        return self.lin(out.reshape(s, h * hd), p["wo"])

    def mla(self, p, x, pos):
        m, h, s = self.port["mla"], self.port["n_heads"], x.shape[0]
        nope, rope, r_kv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                            m["kv_lora_rank"])
        cq = self.norm(p["q_norm"], self.lin(x, p["wq_a"]))
        q = self.lin(cq, p["wq_b"]).view(s, h, nope + rope)
        q_nope, q_rope = q.split([nope, rope], -1)
        kv = self.lin(x, p["wkv_a"])
        ckv = self.norm(p["kv_norm"], kv[:, :r_kv])
        k_rope = self.rope(kv[:, None, r_kv:], pos).expand(s, h, rope)
        k_nope = self.lin(ckv, p["wk_b"]).view(s, h, nope)
        v = self.lin(ckv, p["wv_b"]).view(s, h, m["v_head_dim"])
        qq = torch.cat([q_nope, self.rope(q_rope, pos)], -1)
        kk = torch.cat([k_nope, k_rope], -1)
        out = self.attend(qq, kk, v, (nope + rope) ** -0.5)
        return self.lin(out.reshape(s, -1), p["wo"])

    def moe(self, p, x):
        """Every token to its top-k experts, none dropped."""
        moe = self.port["moe"]
        logits = x @ p["router"].float()
        scores = (torch.sigmoid(logits) if moe["router"] == "sigmoid"
                  else torch.softmax(logits, -1))
        gates, idx = torch.topk(scores, moe["top_k"], dim=-1)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        y = torch.zeros_like(x)
        ex = p["experts"]
        for e in range(ex["w_gate"].shape[0]):
            rows, which = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            w = {name: ex[name][e] for name in ("w_gate", "w_up", "w_down")}
            y.index_add_(0, rows, self.ffn(w, x[rows])
                         * gates[rows, which][:, None])
        if "shared" in p:
            y = y + self.ffn(p["shared"], x)
        return y

    # -- the forward pass ------------------------------------------------
    @torch.no_grad()
    def logits(self, seqs, positions):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._logits(seqs, positions)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _logits(self, seqs, positions):
        port, p = self.port, self.p
        scale = math.sqrt(port["d_model"])
        xs = [self.act(p["embed"][s].float() * scale) for s in seqs]
        pos = [torch.arange(s.numel(), device=s.device) for s in seqs]
        attn = self.mla if port.get("mla") else self.gqa
        for si, (kind, count) in enumerate(self.segments):
            stack = p["segments"][si][0]
            for blk in range(count):
                lp = _index(stack, blk)
                xs = [self.act(x + attn(lp["attn"], self.norm(lp["ln1"], x),
                                        ps)) for x, ps in zip(xs, pos)]
                hs = [self.norm(lp["ln2"], x) for x in xs]
                if kind == "E":
                    ys = self.moe(lp["moe"], torch.cat(hs)).split(
                        [h.shape[0] for h in hs])
                else:
                    ys = [self.ffn(lp["ffn"], h) for h in hs]
                xs = [self.act(x + y) for x, y in zip(xs, ys)]
        head = p["lm_head"]
        out = []
        for x, at in zip(xs, positions):
            h = self.norm(p["final_norm"], x[at])
            out.append(self.lin(h, head)[:, :port["vocab"]])
        return out


Reference = Decoder


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]

"""The yardstick's arithmetic: the card's peaks, the operations and bytes of
each kernel call from its logical inputs, and the model's FLOPs per token.

Frozen here, apart from the program: the peaks are NVIDIA's H100 SXM data
sheet figures (dense bf16 without sparsity, HBM3), as ``repro_torch.
roofline.H100`` has them; the model FLOPs are ``repro_torch.roofline.
model_flops``'s 2 x active parameters per token, without the embedding
lookup (a gather, not a product) and with the attention products.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12            # bf16 FLOP/s, dense
PEAK_BYTES = 3.35e12           # HBM bytes/s


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def moe_gmm_cost(d: int, f: int, group_sizes, elem: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one grouped expert FFN over buckets whose live rows
    are ``group_sizes`` (per expert): per routed row the gate, up and down
    products (6 d f); each live expert's three weight matrices read once,
    and the routed rows read in and written out once. Padding rows, the
    (E, C, F) scratch and dead experts are not counted."""
    rows = int(sum(int(g) for g in group_sizes))
    live = sum(1 for g in group_sizes if int(g) > 0)
    flops = 6 * rows * d * f
    nbytes = (live * 3 * d * f + 2 * rows * d) * elem
    return flops, nbytes


def decode_attn_cost(h: int, hkv: int, d: int, valid_lens,
                     elem: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one single-query decode attention call: per batch
    row, each of the H query heads scores and sums its ``len`` live
    positions (4 d FLOPs a position); each live K and V position of every
    kv head read once, q read and the output written once."""
    total = int(sum(int(n) for n in valid_lens))
    rows = len(valid_lens)
    flops = 4 * total * h * d
    nbytes = (2 * total * hkv * d + 2 * rows * h * d) * elem
    return flops, nbytes


class ModelFlops:
    """FLOPs of a decoder described by a configuration's ``port`` section:
    ``2 * matmul_params`` a token, plus the attention products, 2 x keys
    x heads x (qk width + v width) a token (MLA in its direct form)."""

    def __init__(self, port: dict):
        d, h = port["d_model"], port["n_heads"]
        mla, moe = port.get("mla"), port.get("moe")
        if mla:
            qk = mla["qk_nope_head_dim"] + mla["qk_rope_head_dim"]
            attn = (d * mla["q_lora_rank"] + mla["q_lora_rank"] * h * qk
                    + d * (mla["kv_lora_rank"] + mla["qk_rope_head_dim"])
                    + mla["kv_lora_rank"] * h * (mla["qk_nope_head_dim"]
                                                 + mla["v_head_dim"])
                    + h * mla["v_head_dim"] * d)
            self.attn_width = h * (qk + mla["v_head_dim"])
        else:
            hd, hkv = port["head_dim"], port["n_kv_heads"]
            attn = 2 * d * h * hd + 2 * d * hkv * hd
            self.attn_width = h * 2 * hd
        n = port["n_layers"]
        params = n * attn + d * port["vocab"]              # + the LM head
        if moe:
            dense = moe.get("first_dense_layers", 0)
            params += dense * 3 * d * moe.get("dense_d_ff", 0)
            per = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff"]
            if moe.get("n_shared_experts", 0):
                per += 3 * d * (moe.get("shared_d_ff") or moe["d_ff"])
            params += (n - dense) * per
        else:
            params += n * 3 * d * port["d_ff"]
        self.matmul_params = params
        self.n_layers = n

    def prefill(self, n: int) -> float:
        """A causal prefill of n tokens (token i attends i + 1 keys)."""
        return (2.0 * self.matmul_params * n
                + self.n_layers * self.attn_width * n * (n + 1))

    def decode(self, position: int) -> float:
        """One decoded token at ``position`` (attends position + 1 keys)."""
        return (2.0 * self.matmul_params
                + 2.0 * self.n_layers * self.attn_width * (position + 1))

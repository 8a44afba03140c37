"""The comparison that decides ``correct`` for a served model.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed with the one that served most
tokens in it, is run through the plain reference: one causal forward pass
over each request's padded prompt and its served tokens. The prompt is
left-padded with token 0 to its bucket, as the engine pads it (the
reference works the bucket out again from the traffic's rule). The
served token j is the program's pick at position P - 1 + j (P the padded
length); its gap is how far the reference's logit for it lies below the
reference's best logit there. The traffic file's ``check.limits`` names
the numbers compared, each with its limit (``judge``), from those that
``numbers`` reads: the widest and the mean gap over the sample's served
tokens.

The control is read the same way: at the same positions of the same
sequences, the gap of the token that the reference computed in float8
puts first (``control_picks``).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .traffic import pow2_bucket


def reference(config: dict):
    """The configuration's plain reference class, found by the name its
    file gives (``reference/<name>.py``, class ``Reference``)."""
    mod = importlib.import_module(f"perfbench.reference.{config['reference']}")
    return mod.Reference


def sample(finished: list, k: int, seed: int) -> list:
    """``k`` finished requests drawn from the seed, with the one that served
    most tokens (then the longest prompt) among them."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: (len(finished[i].tokens),
                                  finished[i].prompt_len))
    longest = order[-1]
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 3])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def sequences(reqs: list, cap: int, device):
    """Per request: the reference's input (padded prompt + served tokens
    but the last), the positions of the served tokens' logits, and the
    served tokens."""
    seqs, positions, served = [], [], []
    for r in reqs:
        pad = pow2_bucket(r.prompt_len, cap)
        toks = np.zeros(pad + len(r.tokens) - 1, np.int64)
        toks[pad - r.prompt_len:pad] = r.prompt
        toks[pad:] = r.tokens[:-1]
        seqs.append(torch.from_numpy(toks).to(device))
        positions.append(torch.arange(pad - 1, pad - 1 + len(r.tokens),
                                      device=device))
        served.append(torch.tensor(r.tokens, device=device))
    return seqs, positions, served


def gaps_of(ref_logits, picked) -> list:
    """Per request, per position: the reference's best logit minus its
    logit of the picked token."""
    return [lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
            for lg, t in zip(ref_logits, picked)]


def numbers(gaps: list) -> dict:
    """The widest and the mean gap over every served token, and per
    request (prompt order of the sample) its tokens, mean and widest."""
    flat = torch.cat(gaps)
    return {"max_logit_gap": float(flat.max()),
            "mean_logit_gap": float(flat.mean()),
            "per_request": [[int(g.numel()), float(g.mean()),
                             float(g.max())] for g in gaps]}


def judge(limits: dict, got: dict, failed: int) -> dict:
    """Each compared number beside its limit: the traffic file's
    ``limits``, and unfinished requests (limit 0)."""
    out = {name: {"value": got.get(name), "limit": float(limit)}
           for name, limit in limits.items()}
    out["unfinished_requests"] = {"value": failed, "limit": 0}
    return out


def passed(compared: dict) -> bool:
    return all(v["value"] is not None and v["value"] <= v["limit"]
               for v in compared.values())


def reference_logits(config, params, reqs, cap, device,
                     precision: str = "fp32") -> list:
    """The reference's logits at the served positions of ``reqs``."""
    seqs, positions, _ = sequences(reqs, cap, device)
    return reference(config)(config["port"], params,
                             precision=precision).logits(seqs, positions)


def control_picks(config, params, reqs, cap, device,
                  precision: str = "fp8") -> list:
    """The first choices of the reference computed in ``precision`` (the
    float8 control, or the bf16 witness) at the served positions."""
    low = reference_logits(config, params, reqs, cap, device, precision)
    return [lg.argmax(-1) for lg in low]

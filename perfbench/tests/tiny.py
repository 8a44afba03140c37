"""Tiny cells for the CPU tests: a GQA MoE decoder and an MLA one with a
dense layer and a shared expert, both in float32, and the files that add
them to a copy of the benchmark."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

GQA = {"name": "tiny-gqa", "source": "test", "reference": "decoder",
       "port": {"arch_id": "tiny-gqa", "family": "moe", "n_layers": 2,
                "d_model": 64, "vocab": 256, "n_heads": 4, "n_kv_heads": 2,
                "head_dim": 16, "d_ff": 0, "act": "swiglu",
                "rope_theta": 10000.0, "norm_eps": 1e-6,
                "dtype": "float32",
                "moe": {"n_experts": 4, "top_k": 2, "d_ff": 96,
                        "router": "softmax", "capacity_factor": 2.0}}}
MLA = {"name": "tiny-mla", "source": "test", "reference": "decoder",
       "port": {"arch_id": "tiny-mla", "family": "moe", "n_layers": 3,
                "d_model": 64, "vocab": 256, "n_heads": 4, "n_kv_heads": 4,
                "head_dim": 16, "act": "swiglu", "rope_theta": 10000.0,
                "norm_eps": 1e-6, "dtype": "float32",
                "mla": {"q_lora_rank": 32, "kv_lora_rank": 32,
                        "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
                        "v_head_dim": 16},
                "moe": {"n_experts": 8, "top_k": 2, "d_ff": 48,
                        "n_shared_experts": 1, "shared_d_ff": 48,
                        "router": "sigmoid", "first_dense_layers": 1,
                        "dense_d_ff": 96, "capacity_factor": 4.0}}}

OPEN = {"loop": "open", "rate_rps": 16.0, "drain_s": 30,
        "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                   "min": 5, "max": 30},
        "output": {"dist": "lognormal", "median": 4, "sigma": 0.5,
                   "min": 2, "max": 8},
        "engine": {"batch_slots": 4, "cache_cap": 40, "kernels": True,
                   "bucket_policy": "pow2"},
        "check": {"sample": 12,
                  "limits": {"mean_logit_gap": 1e-4}}}
CLOSED = dict(OPEN, loop="closed", callers=6, depth=8)
DUMMY_METRIC = '''"""Steps the engine took in the window (a test's metric)."""


def read(run):
    return len(run.steps)
'''


def add_cells(dst: Path) -> Path:
    """A copy of the benchmark in ``dst`` with two tiny cells, "t_open"
    (GQA, open loop) and "t_closed" (MLA, closed loop), and a metric
    "dummy_steps", all added as new files and new entries."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = dst / "perfbench"
    for conf in (GQA, MLA):
        (pb / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
        spec["configs"].append({"name": conf["name"], "source": "test",
                                "file": f"perfbench/configs/{conf['name']}"
                                        ".json", "reduced": [], "why": "t"})
    (pb / "traffic" / "tiny_open.json").write_text(json.dumps(OPEN))
    (pb / "traffic" / "tiny_closed.json").write_text(json.dumps(CLOSED))
    (pb / "metrics" / "dummy_steps.py").write_text(DUMMY_METRIC)
    spec["workloads"] += [
        {"name": "t_open", "config": "tiny-gqa", "traffic": "tiny_open",
         "chips": 1, "why": "t"},
        {"name": "t_closed", "config": "tiny-mla", "traffic": "tiny_closed",
         "chips": 1, "why": "t"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            sat = m["name"] == "output_tok_s" or m["name"].endswith(".sat")
            m["workloads"].append("t_closed" if sat else "t_open")
    spec["end_to_end"].append(
        {"name": "dummy_steps", "unit": "steps", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["t_open", "t_closed"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst

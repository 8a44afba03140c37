"""The port's six examples (``examples/torch/*.py``) run on the CPU.

One child process imports each example from its file and calls its
``main`` with ``--device cpu`` (``train_moe`` at 3 steps of 2 x 32
tokens): each runs to its end with its own checks holding (the three
dispatch paths of ``scheduled_dispatch`` agree within 1e-5, every
request gets its tokens, the colocated outputs have their shapes), and
afterwards neither ``jax`` nor anything of the JAX package ``repro`` is
in ``sys.modules``.
"""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {
    "quickstart": [],
    "continuous_serving": [],
    "scheduled_dispatch": [],
    "serve_colocated": [],
    "serve_multi_tenant": [],
    "train_moe": ["--steps", "3", "--batch", "2", "--seq", "32"],
}

_CHILD = """
import importlib.util, json, os, sys
import torch
torch.set_num_threads(2)
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    path = os.path.join(sys.argv[2], name + ".py")
    spec = importlib.util.spec_from_file_location("example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out[name] = mod.main(argv + ["--device", "cpu"])
assert len(out["quickstart"]) > 0
assert out["scheduled_dispatch"] <= 1e-5
assert len(out["train_moe"]) == 3
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("LEAKED", bad)
print("EXAMPLES OK")
"""


def test_examples_run_on_the_cpu_without_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(EXAMPLES),
         os.path.join(REPO, "examples", "torch")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert "LEAKED []" in out.stdout
    assert out.stdout.rstrip().endswith("EXAMPLES OK")
    assert sorted(f[:-3] for f in os.listdir(
        os.path.join(REPO, "examples", "torch")) if f.endswith(".py")) == \
        sorted(EXAMPLES)
    for line in ("all three dispatch implementations agree",
                 "tenant 3 evicted", "loss ", "model B generated:"):
        assert line in out.stdout, line

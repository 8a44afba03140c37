"""The port's serving slice against the JAX reference, on the CPU.

Weights are made by the JAX package and carried across by
``repro_torch.bridge``, so both engines serve the same model; the greedy
token streams must be identical. Reduced phi3.5-MoE (2 layers, d 256,
4 experts, fp32).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro import serving as jax_serving  # noqa: E402
from repro.serving import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import poisson_requests as jax_poisson  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as torch_serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import (ContinuousEngine, EngineConfig,  # noqa: E402
                                 make_bucketer, poisson_requests)

ARCH = "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module")
def weights():
    cfg = jax_get_config(ARCH).reduced()
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


@pytest.mark.parametrize("bucket_policy", ["pow2", "exact"])
def test_greedy_streams_match_jax_engine(weights, bucket_policy):
    """A Poisson stream with more requests than slots (so slots are reused
    and vacant slots decode) gives byte-identical greedy streams."""
    cfg_j = jax_get_config(ARCH).reduced()
    eng_j = JaxEngine(JaxModel(cfg_j), jax.tree.map(jax.numpy.asarray, weights),
                      batch_slots=3, cache_cap=48,
                      config=JaxEngineConfig(kernels=True,
                                             bucket_policy=bucket_policy))
    model = Model(get_config(ARCH).reduced(), device="cpu")
    eng_t = ContinuousEngine(model, bridge.to_torch(weights), batch_slots=3,
                             cache_cap=48,
                             config=EngineConfig(kernels=True,
                                                 bucket_policy=bucket_policy))

    def stream(make):
        rng = np.random.default_rng(7)
        reqs = make(rng, 7, 0.8, cfg_j.vocab, 9, 3, 10)
        for i, r in enumerate(reqs):          # ragged prompt lengths
            r.prompt = r.prompt[: 5 + (i * 3) % 9]
        return reqs

    want = eng_j.serve(stream(jax_poisson))
    got = eng_t.serve(stream(poisson_requests))
    assert _streams(got) == _streams(want)
    assert eng_t.decode_steps == eng_j.decode_steps
    assert all(len(r.out_tokens) == r.max_new_tokens for r in got)


# Chunked engine configurations, built in either package (``m`` is
# repro.serving or repro_torch.serving): serialised and pooled, with and
# without a step budget (as the reference's
# test_pooled_prefill_token_identity), EDF with a TTFT tenant, and EDF with
# shedding on a burst.
CHUNKED = {
    "chunk4_pool1": lambda m: dict(prefill_chunk=4),
    "chunk4_pool3": lambda m: dict(prefill_chunk=4, prefill_pool=3),
    "chunk4_budget9_pool1": lambda m: dict(prefill_chunk=4,
                                           step_token_budget=9),
    "chunk4_budget9_pool3": lambda m: dict(prefill_chunk=4,
                                           step_token_budget=9,
                                           prefill_pool=3),
    "edf_ttft": lambda m: dict(
        admission=m.EdfAdmission(chunk=4, budget=9), prefill_pool=2,
        tenants=(m.TenantSpec(name="t0", ttft_p95=6.0),)),
    "edf_shed_burst": lambda m: dict(
        admission=m.EdfAdmission(chunk=4, budget=9, shed=True, queue_cap=3),
        tenants=(m.TenantSpec(name="t0", ttft_p95=2.0),)),
}


def _chunked_stream(m, burst: bool):
    """Ragged prompts (5-12 tokens: one to three chunks of 4) with bursty
    arrivals; one request carries a tight explicit deadline, so EDF
    reorders. ``burst``: ten requests at once, more than the queue cap."""
    rng = np.random.default_rng(0)
    arrivals = ([0.0] * 10 if burst
                else [0.0, 0.0, 1.0, 1.0, 2.0, 5.0, 6.0])
    reqs = []
    for t in arrivals:
        n = int(rng.integers(5, 13))
        reqs.append(m.Request(prompt=[int(x) for x in rng.integers(1, 500, n)],
                              max_new_tokens=int(rng.integers(3, 7)),
                              arrival=t))
    reqs[4].deadline = 3.0
    return reqs


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_chunked_streams_match_jax_engine(weights, case):
    """Chunked, pooled, budgeted and EDF admission give the JAX engine's
    greedy streams byte for byte (kernels=True on both sides), the same
    number of decode steps, and the same shed events."""
    burst = case == "edf_shed_burst"
    cfg_j = jax_get_config(ARCH).reduced()
    eng_j = JaxEngine(JaxModel(cfg_j), jax.tree.map(jax.numpy.asarray, weights),
                      batch_slots=3, cache_cap=32,
                      config=JaxEngineConfig(kernels=True,
                                             **CHUNKED[case](jax_serving)))
    eng_t = ContinuousEngine(
        Model(get_config(ARCH).reduced(), device="cpu"),
        bridge.to_torch(weights), batch_slots=3, cache_cap=32,
        config=EngineConfig(kernels=True, **CHUNKED[case](torch_serving)))
    want = eng_j.serve(_chunked_stream(jax_serving, burst))
    got = eng_t.serve(_chunked_stream(torch_serving, burst))
    assert _streams(got) == _streams(want)
    assert eng_t.decode_steps == eng_j.decode_steps
    assert eng_t.num_pending == 0 and not eng_t.queue

    def sheds(eng):
        return [(e.tenant, e.arrival, e.reason) for e in eng.shed_events]

    assert sheds(eng_t) == sheds(eng_j)
    triggers = {e.reason.split(":")[0] for e in eng_t.shed_events}
    assert triggers == ({"deadline", "queue_cap"} if burst else set())
    shed = {id(e.request) for e in eng_t.shed_events}
    assert all(len(r.out_tokens) == r.max_new_tokens
               for r in got if id(r) not in shed)


def test_bridge_round_trip_is_bit_exact(weights):
    """params and a per-slot cache survive numpy -> torch -> numpy bit for
    bit, with every leaf path kept; bf16 leaves cross as bit patterns."""
    cfg = jax_get_config(ARCH).reduced()
    cache = jax.tree.map(np.asarray,
                         JaxModel(cfg).init_cache(2, 16, per_slot_len=True))
    cache["len"] = np.array([3, 11], np.int32)
    bf16 = {"w": np.asarray(jax.numpy.asarray(
        np.random.default_rng(0).standard_normal((3, 5)), jax.numpy.bfloat16))}
    for tree in (weights, cache, bf16):
        back = bridge.to_numpy(bridge.to_torch(tree))
        paths = bridge.leaf_paths(tree)
        assert sorted(map(str, bridge.leaf_paths(back))) == sorted(map(str, paths))
        for path in paths:
            a, b = tree, back
            for key in path:
                a, b = a[key], b[key]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_port_imports_no_jax_and_nothing_of_repro():
    """Importing the port and every submodule (the planner copy, the
    monitor, the colocated engines, health, faults, telemetry, the
    expert-parallel modules and the DeepSeek-V3 config included) leaves
    ``jax`` and the JAX package out of ``sys.modules``; so does importing
    chip_smoke.py."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "new = {'repro_torch.serving.events', 'repro_torch.serving.monitor',\n"
        "       'repro_torch.serving.colocated', 'repro_torch.core.planner',\n"
        "       'repro_torch.core.simulator', 'repro_torch.core.schedule',\n"
        "       'repro_torch.serving.health', 'repro_torch.serving.faults',\n"
        "       'repro_torch.serving.telemetry',\n"
        "       'repro_torch.distributed.alltoall',\n"
        "       'repro_torch.distributed.group',\n"
        "       'repro_torch.distributed.overlap',\n"
        "       'repro_torch.serving.distributed',\n"
        "       'repro_torch.sharding.rules', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.configs.deepseek_v3_671b'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "sys.path.insert(0, %r)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(names))\n"
        "assert not bad, bad\n" % root)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 47       # every submodule walked


def test_default_device_is_the_card():
    """Without a card, the default device raises; device='cpu' runs."""
    cfg = get_config(ARCH).reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced"])
    model = Model(cfg, device="cpu")
    assert model.device.type == "cpu"
    ContinuousEngine(model, model.init(0), batch_slots=2, cache_cap=16)


@pytest.mark.parametrize("extra", [
    [],
    ["--prefill-chunk", "4", "--prefill-pool", "2", "--step-budget", "9"],
    ["--prefill-chunk", "4", "--step-budget", "9", "--ttft-slo", "12",
     "--tpot-slo", "2"],
], ids=["one_shot", "chunked_pool_budget", "ttft_slo"])
def test_launch_serve_on_cpu(capsys, extra):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--num-requests", "3", "--batch", "2",
                       "--cache-cap", "32", "--max-new-tokens", "4",
                       "--kernels"] + extra) == 0
    out = capsys.readouterr().out
    assert "tokens in" in out
    assert ("EDF admission" in out) == ("--ttft-slo" in extra)


@pytest.mark.parametrize("policy", ["pow2", "exact", "step:8"])
def test_bucketer_matches_reference(policy):
    from repro.serving.config import make_bucketer as jax_bucketer
    ours, ref = make_bucketer(policy), jax_bucketer(policy)
    assert [ours(n) for n in range(1, 300)] == [ref(n) for n in range(1, 300)]


def test_engine_config_validation():
    with pytest.raises(ValueError):
        EngineConfig(bucket_policy="nope")
    with pytest.raises(ValueError):
        EngineConfig(prefill_len=0)
    with pytest.raises(KeyError):
        get_config("qwen3-32b")
    model = Model(get_config(ARCH).reduced(), device="cpu")
    eng = ContinuousEngine(model, model.init(0), batch_slots=2, cache_cap=16)
    from repro_torch.serving import Request
    with pytest.raises(ValueError, match="cache slots"):
        eng.submit(Request(prompt=[1] * 9, max_new_tokens=9))

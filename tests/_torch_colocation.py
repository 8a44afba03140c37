"""Shared setup of the port's colocation tests (``test_torch_colocated``,
``test_torch_multi_tenant``, ``test_torch_colocated_families*``): each
package's engines, models and params behind one namespace, seeded request
streams and exact comparisons."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro import serving as jserving
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro_torch import bridge
from repro_torch import core as tcore
from repro_torch import serving as tserving
from repro_torch.configs import get_config
from repro_torch.models import Model

ARCH = "phi3.5-moe-42b-a6.6b"
N_E = 4
PAIR0 = [2, 0, 3, 1]


@pytest.fixture(scope="module")
def weights():
    """Reduced-model weights of seeds 0-3, made by the JAX package (a
    module-scoped fixture: import it into the test module)."""
    cfg = jax_get_config(ARCH).reduced()
    return [jax.tree.map(np.asarray, JaxModel(cfg).init(
        jax.random.PRNGKey(seed))) for seed in range(4)]


def side(name):
    """The JAX package ("jax") or the port on the CPU: its serving and core
    modules, reduced config, a model factory and a params converter."""
    if name == "jax":
        cfg = jax_get_config(ARCH).reduced()
        return types.SimpleNamespace(
            m=jserving, core=jcore, cfg=cfg, model=lambda: JaxModel(cfg),
            params=lambda w: jax.tree.map(jnp.asarray, w))
    cfg = get_config(ARCH).reduced()
    return types.SimpleNamespace(
        m=tserving, core=tcore, cfg=cfg,
        model=lambda: Model(cfg, device="cpu"),
        params=lambda w: bridge.to_torch(w, device="cpu"))


JAX, PORT = side("jax"), side("torch")


def reqs(m, seed, n=3):
    """Ragged prompts (5-12 tokens), bursty arrivals."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(5, 13))
        out.append(m.Request(prompt=[int(x) for x in rng.integers(1, 500, k)],
                             max_new_tokens=int(rng.integers(3, 7)),
                             arrival=float(i // 2)))
    return out


def streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


def events(eng):
    return [(e.step, e.stale_time, e.candidate_time, list(e.pair), e.applied,
             None if e.groups is None else [tuple(g) for g in e.groups])
            for e in eng.replan_events]


def forced(s, cluster="homogeneous_cluster", interval=3):
    """A re-planner that adopts every changed placement."""
    return s.m.OnlineReplanner(
        s.core.AuroraPlanner(getattr(s.core, cluster)(N_E)),
        interval=interval, threshold=-1.0, warmup=1)


def leaves_equal(tree_t, tree_j):
    got, want = bridge.to_numpy(tree_t), jax.tree.map(np.asarray, tree_j)
    for path in bridge.leaf_paths(want):
        a, b = got, want
        for key in path:
            a, b = a[key], b[key]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def colocated_run(s, weights, chunked, replan):
    """Tenants A (seed 0) and B (seed 1, pairing ``PAIR0``) in a
    ``ColocatedContinuousEngine`` (kernels on, 2 slots, cache 32), one-shot
    or in chunks of 4, with a forced re-planner or none. Returns the
    engine and both tenants' streams."""
    params_b = s.m.apply_pairing(s.params(weights[1]), PAIR0, s.cfg)
    eng = s.m.ColocatedContinuousEngine(
        s.model(), s.model(), s.params(weights[0]), params_b,
        batch_slots=2, cache_cap=32,
        config=s.m.EngineConfig(kernels=True,
                                prefill_chunk=4 if chunked else None),
        pair=PAIR0, replan=forced(s) if replan else None)
    ra, rb = eng.serve(reqs(s.m, 1), reqs(s.m, 2))
    return eng, [streams(ra), streams(rb)]


# -- the ssm, hybrid and vlm families beside phi3.5-MoE ----------------------

FAMILIES = ["mamba2-1.3b", "zamba2-7b", "qwen2-vl-7b"]
SSM, HYBRID, VLM = FAMILIES
AUDIO = "seamless-m4t-large-v2"
DENSE = "phi4-mini-3.8b"


@functools.lru_cache(maxsize=None)
def arch_weights(arch, seed):
    """JAX params of the reduced ``arch`` as numpy leaves, made once
    (jitted: the eager init of the SSM families takes seconds)."""
    cfg = jax_get_config(arch).reduced()
    return jax.tree.map(np.asarray, jax.jit(JaxModel(cfg).init)(
        jax.random.PRNGKey(seed)))


def tenant(s, arch, seed):
    """(model, params) of the reduced ``arch`` on side ``s`` (``JAX`` or
    ``PORT``), with the weights of ``seed``; fresh tensors on the port."""
    w = arch_weights(arch, seed)
    if s is JAX:
        return (JaxModel(jax_get_config(arch).reduced()),
                jax.tree.map(jnp.asarray, w))
    return (Model(get_config(arch).reduced(), device="cpu"),
            bridge.to_torch(w, device="cpu"))


ADMISSION = {"one_shot": {}, "chunk4": {"prefill_chunk": 4},
             "pool2": {"prefill_chunk": 4, "prefill_pool": 2}}


def family_config(s, admission):
    """The kernel path with one of ``ADMISSION``'s admissions."""
    return s.m.EngineConfig(kernels=True, **ADMISSION[admission])


def family_run(s, arch, admission):
    """phi3.5-MoE (seed 0) and ``arch`` (seed 1) in a
    ``ColocatedContinuousEngine`` (2 slots, cache 32) serving ``reqs``
    streams of seeds 1 and 2. Returns the engine and both streams."""
    (ma, pa), (mb, pb) = tenant(s, ARCH, 0), tenant(s, arch, 1)
    eng = s.m.ColocatedContinuousEngine(ma, mb, pa, pb, batch_slots=2,
                                        cache_cap=32,
                                        config=family_config(s, admission))
    ra, rb = eng.serve(reqs(s.m, 1), reqs(s.m, 2))
    return eng, [streams(ra), streams(rb)]

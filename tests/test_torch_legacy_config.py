"""The reference's deprecated engine keywords and ``chunk_budget`` shims in
the port, against the reference, on the CPU.

Each of the reference's old constructor keywords (``_LEGACY_KEYS``) makes
the port's ``ContinuousEngine`` and the reference's warn once
(``DeprecationWarning``) and fold to equal ``EngineConfig``s; engines built
so serve the reference's greedy streams byte for byte (reduced
phi3.5-MoE, weights seeded by the port and carried across with numpy). A
policy with only the old int-based ``chunk_budget`` is shimmed with one
warning and serves the reference's stream; the stock policies'
``chunk_budget`` counts equal the reference's; the misuses raise the
reference's errors, with its messages (``repro_torch.serving`` named where
the reference names ``repro.serving``); and all six engine classes take
the keywords, the ``Distributed*`` ones over ``LocalGroup(4, "cpu")``.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import config as jconfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.models import Model, init_params  # noqa: E402
from repro_torch.serving import config as tconfig  # noqa: E402

ARCH = "phi3.5-moe-42b-a6.6b"
MSG = "is deprecated — pass config=EngineConfig"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the engines run many small ops, which
    several test workers on one host slow down when multi-threaded."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wrap(fn):
    """A step wrapper both packages accept (it calls the step as is)."""
    return fn


# One value per legacy keyword (``step_token_budget`` needs a chunk).
LEGACY = {
    "prefill_len": dict(prefill_len=16),
    "prefill_chunk": dict(prefill_chunk=4),
    "step_token_budget": dict(prefill_chunk=4, step_token_budget=9),
    "bucket_policy": dict(bucket_policy="exact"),
    "kernels": dict(kernels=True),
    "jit": dict(jit=False),
    "step_wrapper": dict(step_wrapper=_wrap),
}


@pytest.fixture(scope="module")
def weights():
    return bridge.to_numpy(init_params(get_config(ARCH).reduced(), 0, "cpu"))


def _port_engine(weights, **kw):
    return tserving.ContinuousEngine(
        Model(get_config(ARCH).reduced(), device="cpu"),
        bridge.to_torch(weights, device="cpu"), 2, 32, **kw)


def _jax_engine(weights, **kw):
    return jserving.ContinuousEngine(
        JaxModel(jax_get_config(ARCH).reduced()),
        jax.tree.map(jax.numpy.asarray, weights), 2, 32, **kw)


def _deprecations(build):
    """(what ``build()`` returns, its DeprecationWarning messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = build()
    return out, [str(w.message) for w in caught
                 if issubclass(w.category, DeprecationWarning)
                 and "deprecated" in str(w.message)]


def _ported(msg: str) -> str:
    """A reference message as the port words it."""
    return msg.replace("repro.serving", "repro_torch.serving")


def _fields(config) -> dict:
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config)}


def test_engine_config_has_the_reference_fields():
    assert list(_fields(tconfig.EngineConfig())) == list(
        _fields(jconfig.EngineConfig()))
    assert tconfig._LEGACY_KEYS == jconfig._LEGACY_KEYS == tuple(LEGACY)
    assert tconfig.EngineConfig().jit is True


@pytest.mark.parametrize("key", list(LEGACY))
def test_legacy_keyword_warns_once_and_folds_like_the_reference(weights,
                                                                key):
    kw = LEGACY[key]
    got, msgs_t = _deprecations(lambda: _port_engine(weights, **kw))
    want, msgs_j = _deprecations(lambda: _jax_engine(weights, **kw))
    assert len(msgs_t) == len(msgs_j) == 1
    assert msgs_t[0] == _ported(msgs_j[0]) and MSG in msgs_t[0]
    assert _fields(got.config) == _fields(want.config)
    assert got.config == tconfig.EngineConfig(**kw)


def _requests(m):
    """Ragged prompts (5-11 tokens) arriving over three steps."""
    rng = np.random.default_rng(4)
    return [m.Request(prompt=[int(t) for t in rng.integers(1, 500, n)],
                      max_new_tokens=4, arrival=float(i // 2))
            for i, n in enumerate((7, 11, 5, 9))]


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


class _OldPolicy:
    """A third-party policy of the old protocol: ``chunk_budget`` over bare
    chunk sizes (admit the chunks that fit 6 tokens), no ``select``."""

    chunk, budget = 3, 6

    def pad(self, prompt_len: int) -> int:
        return prompt_len

    def chunk_budget(self, num_active, chunks):
        left, k = self.budget, 0
        for c in chunks:
            if c > left:
                break
            left -= c
            k += 1
        return k


@pytest.mark.parametrize("how", ["chunk_and_budget", "kernels",
                                 "chunk_budget_policy"])
def test_legacy_engines_serve_the_reference_streams(weights, how):
    def build(make, m):
        if how == "chunk_and_budget":
            return make(weights, prefill_chunk=4, step_token_budget=9)
        if how == "kernels":
            return make(weights, kernels=True)
        return make(weights, config=m.EngineConfig(admission=_OldPolicy()))

    eng_t, msgs_t = _deprecations(lambda: build(_port_engine, tserving))
    eng_j, msgs_j = _deprecations(lambda: build(_jax_engine, jserving))
    got, more_t = _deprecations(lambda: eng_t.serve(_requests(tserving)))
    want, more_j = _deprecations(lambda: eng_j.serve(_requests(jserving)))
    assert len(msgs_t + more_t) == len(msgs_j + more_j) == 1
    assert _streams(got) == _streams(want)
    assert eng_t.decode_steps == eng_j.decode_steps
    assert all(len(r.out_tokens) == r.max_new_tokens for r in got)


def test_stock_policies_answer_chunk_budget_as_the_reference():
    chunks = [4, 4, 3, 2, 4]
    cases = (("FifoAdmission", {}), ("LengthBucketedAdmission",
                                     {"chunk": 4}),
             ("TokenBudgetAdmission", {"chunk": 4, "budget": 9}),
             ("EdfAdmission", {"chunk": 4, "budget": 9}),
             ("EdfAdmission", {"chunk": 4}))
    for name, kw in cases:
        for active in (0, 1, 3):
            got, msgs_t = _deprecations(lambda: getattr(tserving, name)(
                **kw).chunk_budget(active, chunks))
            want, msgs_j = _deprecations(lambda: getattr(jserving, name)(
                **kw).chunk_budget(active, chunks))
            assert got == want, (name, kw, active)
            assert len(msgs_t) == len(msgs_j) == 1
            assert msgs_t[0] == _ported(msgs_j[0])


def _raised(build):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises((TypeError, ValueError)) as info:
            build()
    return info.type, str(info.value)


@pytest.mark.parametrize("misuse", ["unknown_keyword", "config_and_legacy",
                                    "not_a_policy"])
def test_misuses_raise_the_reference_errors(weights, misuse):
    def build(make, m):
        if misuse == "unknown_keyword":
            return make(weights, prefill_chunk=4, chunk_size=4)
        if misuse == "config_and_legacy":
            return make(weights, config=m.EngineConfig(), kernels=True)
        return make(weights, config=m.EngineConfig(admission=object()))

    kind_t, msg_t = _raised(lambda: build(_port_engine, tserving))
    kind_j, msg_j = _raised(lambda: build(_jax_engine, jserving))
    assert kind_t is kind_j
    assert msg_t == _ported(msg_j)


def test_every_engine_class_takes_the_legacy_keywords(weights):
    """Each of the six engines, built with ``prefill_chunk`` and
    ``kernels``, warns once and holds the folded config; the colocated
    and multi-tenant engines' pools chunk by 4 and run kernelized models,
    and the distributed engine serves the plain engine's stream."""
    cfg = get_config(ARCH).reduced()
    kw = dict(prefill_chunk=4, kernels=True)
    want_cfg = tserving.EngineConfig(**kw)

    def model():
        return Model(cfg, device="cpu")

    def params():
        return bridge.to_torch(weights, device="cpu")

    def group():
        return LocalGroup(4, "cpu")

    builds = {
        "ContinuousEngine": lambda: tserving.ContinuousEngine(
            model(), params(), 2, 32, **kw),
        "ColocatedContinuousEngine": lambda:
            tserving.ColocatedContinuousEngine(
                model(), model(), params(), params(), 2, 32, **kw),
        "MultiTenantContinuousEngine": lambda:
            tserving.MultiTenantContinuousEngine(
                [model(), model()], [params(), params()], 2, 32, **kw),
        "DistributedEngine": lambda: tserving.DistributedEngine(
            model(), params(), 2, 32, group=group(), **kw),
        "DistributedColocatedEngine": lambda:
            tserving.DistributedColocatedEngine(
                model(), model(), params(), params(), 2, 32, group=group(),
                **kw),
        "DistributedMultiTenantEngine": lambda:
            tserving.DistributedMultiTenantEngine(
                [model(), model()], [params(), params()], 2, 32,
                group=group(), **kw),
    }
    engines = {}
    for name, build in builds.items():
        eng, msgs = _deprecations(build)
        assert [m.split("(")[0] for m in msgs] == [name], name
        assert eng.config == want_cfg, name
        pools = getattr(eng, "pools", None) or [
            getattr(eng, p) for p in ("pool_a", "pool_b")
            if hasattr(eng, p)]
        assert all(p.admission.chunk == 4 and p.model.kernels is not None
                   for p in pools), name
        engines[name] = eng
    with pytest.warns(DeprecationWarning), pytest.raises(
            TypeError, match="unexpected keyword"):
        tserving.DistributedEngine(model(), params(), 2, 32, group=group(),
                                   prefill_chunk=4, chunk_size=4)
    got = engines["DistributedEngine"].serve(_requests(tserving))
    want = engines["ContinuousEngine"].serve(_requests(tserving))
    assert _streams(got) == _streams(want)

"""The port's EP exchange against the JAX reference, on the CPU.

The host-side round builders must equal ``repro.distributed.alltoall``'s
exactly (the same rounds for the same schedules, the same errors for the
same bad inputs). ``ep_all_to_all``, the monolithic baseline and two round
schedules, is held against the JAX ``ep_all_to_all`` on a 4-device host
mesh (one child process), on ``LocalGroup(4)`` in this process and on 4
gloo ranks.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core.schedule import CommSchedule as JSchedule  # noqa: E402
from repro.core.schedule import Slot as JSlot  # noqa: E402
from repro.distributed import alltoall as jall  # noqa: E402
from repro.serving import distributed as jdist  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core.schedule import CommSchedule, Slot  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.distributed import alltoall as tall  # noqa: E402
from repro_torch.serving import distributed as tdist  # noqa: E402

from _torch_ep import N_RANKS, gloo_run, jax_mesh_run  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the EP paths run many small ops per rank, and
    several test workers on one host make every multi-threaded op wait for
    descheduled threads (tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traffic(n, seed, density):
    rng = np.random.default_rng(seed)
    d = rng.random((n, n)) * (rng.random((n, n)) < density)
    np.fill_diagonal(d, 0.0)
    return d


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_round_builders_equal_the_reference(n):
    """Round robin, and the BvN rounds of schedules of random traffic
    (dense, sparse, all-zero; fixed seeds), equal the reference's."""
    assert tall.round_robin_rounds(n) == jall.round_robin_rounds(n)
    for seed, density in ((0, 1.0), (1, 0.4), (2, 0.0), (7, 0.7)):
        d = _traffic(n, seed, density)
        got = tall.aurora_rounds_from_schedule(tcore.aurora_schedule(d), n)
        want = jall.aurora_rounds_from_schedule(jcore.aurora_schedule(d), n)
        assert got == want
        assert tall.validate_rounds_cover(got, n) == \
            jall.validate_rounds_cover(want, n)


def test_rank_rounds_from_traces_equal_the_reference():
    """Expert-granularity traces aggregated onto 2-16 ranks give the
    reference's rounds and rank traffic."""
    for seed in (0, 11):
        kw = dict(n_experts=16, n_layers=3, seed=seed)
        tt, jt = tcore.synthetic_trace("t", **kw), jcore.synthetic_trace(
            "t", **kw)
        for n in (2, 4, 8, 16):
            assert tdist.rounds_from_trace(tt, n) == \
                jdist.rounds_from_trace(jt, n)
        np.testing.assert_array_equal(tdist.device_traffic(tt.layer(0), 4),
                                      jdist.device_traffic(jt.layer(0), 4))
    with pytest.raises(ValueError, match="do not shard"):
        tdist.device_traffic(tt.layer(0), 5)


def _raises_alike(fn_t, fn_j, *args_pairs):
    with pytest.raises(ValueError) as et:
        fn_t(*args_pairs[0])
    with pytest.raises(ValueError) as ej:
        fn_j(*args_pairs[1])
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("case", [
    ("truncated", lambda rr: rr[:-1], 4),
    ("duplicate", lambda rr: rr + rr[-1:], 4),
    ("two_senders", lambda rr: ((1, -1, 1),), 3),
    ("self_send", lambda rr: ((0, -1, -1),), 3),
    ("out_of_range", lambda rr: ((9, -1, -1),), 3),
    ("short", lambda rr: ((1, 0),), 3),
], ids=lambda c: c[0])
def test_validate_rounds_cover_raises_alike(case):
    """The bad literal round sequences of the reference's own test raise
    the same error with the same message."""
    _, make, n = case
    rounds = make(jall.round_robin_rounds(4))
    _raises_alike(tall.validate_rounds_cover, jall.validate_rounds_cover,
                  (rounds, n), (rounds, n))


@pytest.mark.parametrize("dst", [[1, -1, 1], [0, 2, 1], [3, -1, -1], [1, 0]])
def test_malformed_slots_raise_alike(dst):
    _raises_alike(
        tall.aurora_rounds_from_schedule, jall.aurora_rounds_from_schedule,
        (CommSchedule(slots=(Slot(dst=tuple(dst), duration=1.0),),
                      b_max=1.0), 3),
        (JSchedule(slots=(JSlot(dst=tuple(dst), duration=1.0),),
                   b_max=1.0), 3))


# -- ep_all_to_all against the JAX exchange on a host mesh ---------------------

_JAX_EXCHANGE = """
import json
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed import ep_all_to_all
mesh = jax.make_mesh((4,), ("ep",))
x = jnp.asarray(IN["bufs"].reshape((-1,) + IN["bufs"].shape[2:]))
for name, rounds in json.loads(str(IN["variants"])).items():
    rounds = None if rounds is None else tuple(map(tuple, rounds))
    y = jax.jit(shard_map(
        lambda b, rounds=rounds: ep_all_to_all(b, ("ep",), rounds),
        mesh=mesh, in_specs=P("ep"), out_specs=P("ep"),
        check_vma=False))(x)
    OUT[name] = np.asarray(y).reshape(IN["bufs"].shape)
"""


def _variants():
    d = _traffic(N_RANKS, 3, 0.6)
    return {"baseline": None,
            "round_robin": tall.round_robin_rounds(N_RANKS),
            "bvn": tall.aurora_rounds_from_schedule(
                tcore.aurora_schedule(d), N_RANKS)}


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    """Per-rank (n, 3, 5) buffers from a seed, and the JAX exchange of them
    under each rounds variant."""
    rng = np.random.default_rng(5)
    bufs = rng.standard_normal((N_RANKS, N_RANKS, 3, 5)).astype(np.float32)
    variants = _variants()
    want = jax_mesh_run(_JAX_EXCHANGE, tmp_path_factory.mktemp("jax"),
                        {"bufs": bufs, "variants": json.dumps(variants)})
    return bufs, variants, want


def test_exchange_on_local_group_matches_jax(exchange):
    """``LocalGroup(4)``: every variant equals the JAX exchange bit for bit
    (out[s] = what rank s sent), and the rounds count one copy per pair."""
    bufs, variants, want = exchange
    for name, rounds in variants.items():
        group = LocalGroup(N_RANKS, "cpu")
        got = tall.ep_all_to_all([torch.from_numpy(b) for b in bufs], group,
                                 rounds)
        np.testing.assert_array_equal(np.stack([g.numpy() for g in got]),
                                      want[name])
        np.testing.assert_array_equal(want[name], bufs.transpose(1, 0, 2, 3))
        pairs = sum(j >= 0 for r in (rounds or ()) for j in r)
        assert group.copies == pairs
        assert group.copy_bytes == pairs * bufs[0, 0].nbytes


def test_exchange_on_gloo_ranks_matches_jax(exchange, tmp_path):
    """4 gloo ranks (``DistGroup``: ``all_to_all_single`` and one
    ``batch_isend_irecv`` per round) give the JAX exchange bit for bit."""
    bufs, variants, want = exchange
    outs = gloo_run("exchange_worker", str(tmp_path), bufs, variants)
    for name in variants:
        np.testing.assert_array_equal(
            np.stack([o[name] for o in outs]), want[name])

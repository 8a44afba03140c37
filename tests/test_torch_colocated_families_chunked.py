"""The port's dual-model colocated engine with chunked and pooled
admission, with a tenant of the ssm, hybrid or vlm family beside
phi3.5-MoE, against the JAX reference on the CPU.

Reduced fp32 configs and the streams of
``test_torch_colocated_families.py``. Chunks of 4 (an SSM state, a hybrid's
shared-block KV and a vlm's KV continue across chunks; between chunks the
lockstep step freezes the row) and a pool of 2 chunked prefills in
flight: both tenants' greedy streams and the lockstep step count equal the
JAX engine's, and the family tenant's stream equals its one-shot stream.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_colocation import (FAMILIES, JAX, PORT,  # noqa: E402
                               family_run)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (many small ops; several test workers share the
    host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("admission", ["chunk4", "pool2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_dual_engine_chunked_streams_equal_jax(arch, admission):
    eng_j, want = family_run(JAX, arch, admission)
    eng_t, got = family_run(PORT, arch, admission)
    assert got == want
    assert eng_t.decode_steps == eng_j.decode_steps
    assert eng_t.pool_b.prefills > len(got[1])     # several chunks each
    assert got[1] == family_run(PORT, arch, "one_shot")[1][1]

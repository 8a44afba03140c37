"""The port's sizing layer against the JAX reference, on the CPU.

``configs.SHAPES``; ``ModelConfig.attention_free``, ``subquadratic``,
``supports_decode``, ``param_count`` and ``active_param_count`` for the ten
archs, full and reduced; ``roofline.model_flops`` for the four shapes and
``roofline_report`` on the same inputs (the reference given the port's H100
constants): all exactly equal. ``roofline.ep_round_bytes`` equals the bytes
``LocalGroup(4, "cpu")`` copies over one reduced MoE step, with the kernel
path off and on (which pads a rank's rows to whole kernel tiles), on the
synchronous rounds and the pipelined ones. ``init_params`` on ``meta`` has
the CPU tree's shapes and dtypes and no data, and the CPU numbers for a
seed are the ones they were before the ``meta`` branch was added (a
digest of their bytes).
"""

import dataclasses
import hashlib

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro import roofline as jroofline  # noqa: E402
from repro_torch import configs, roofline  # noqa: E402
from repro_torch.bridge import tree_leaves  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.models import KernelConfig, Model, ParallelContext  # noqa: E402
from repro_torch.models import init_params, moe_layer_count  # noqa: E402

SIZES = ("attention_free", "subquadratic", "supports_decode")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: several test workers on one host make every
    multi-threaded op wait for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(jconfigs.SHAPES)
    for name, shape in SHAPES.items():
        assert isinstance(shape, InputShape)
        assert (dataclasses.astuple(shape)
                == dataclasses.astuple(jconfigs.SHAPES[name]))
    assert configs.TRAIN_4K == SHAPES["train_4k"]
    assert configs.LONG_500K.global_batch == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_sizes_and_model_flops_equal_the_reference(arch, reduced):
    cfg, ref = get_config(arch), jconfigs.get_config(arch)
    if reduced:
        cfg, ref = cfg.reduced(), ref.reduced()
    for name in SIZES:
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    for name, shape in SHAPES.items():
        got = roofline.model_flops(cfg, shape)
        assert got == jroofline.model_flops(ref, jconfigs.SHAPES[name])


def test_roofline_report_equals_the_reference_on_h100_constants():
    h = roofline.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    jhw = jroofline.HW(h.peak_flops, h.hbm_bw, h.link_bw)
    cfg, ref = get_config("deepseek-v3-671b"), jconfigs.get_config(
        "deepseek-v3-671b")
    for name in SHAPES:
        for args in ((3.1e15, 2.2e12, 4.0e10, 4), (0.0, 5e9, 0.0, 1)):
            kw = dict(arg_bytes=1.5e12, out_bytes=2e9)
            got = roofline.roofline_report(*args, cfg=cfg,
                                           shape=SHAPES[name], **kw)
            want = jroofline.roofline_report(
                *args, cfg=ref, shape=jconfigs.SHAPES[name], hw=jhw, **kw)
            assert got == want
    assert roofline.roofline_report(0.0, 0.0, 0.0, 1) == {
        "compute_s": 0.0, "memory_s": 0.0, "collective_s": 0.0,
        "dominant": "none"}


def _ep_copy_bytes(cfg, kind, n_tokens, kernels, overlap):
    """``LocalGroup(4, "cpu").copy_bytes`` over one step of ``cfg`` on the
    aurora rounds (round robin), from a fresh cache."""
    group = LocalGroup(4, "cpu")
    pc = ParallelContext(group=group, moe_impl="aurora", ep_overlap=overlap)
    model = Model(cfg, device="cpu", pc=pc,
                  kernels=KernelConfig(block_c=3) if kernels else None)
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if kind == "decode":
            cache = model.init_cache(n_tokens, 16)
            tok = torch.randint(0, cfg.vocab, (n_tokens, 1), generator=gen)
            model.decode_step(params, tok, cache)
        else:
            cache = model.init_cache(1, n_tokens)
            tok = torch.randint(0, cfg.vocab, (1, n_tokens), generator=gen)
            model.prefill(params, {"tokens": tok}, cache)
    return group.copy_bytes


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v3-671b"])
def test_ep_round_bytes_equal_the_group_copy_bytes(arch, kernels, overlap):
    """A decode step of 6 rows (2 a rank, 2 pad rows) and a prefill of 13
    tokens (4 a rank, 3 pad rows): capacities 2 and 4 a source. With
    ``block_c`` 3 the kernel path pads every grouped FFN's rows (8 -> 9
    and 16 -> 18 synchronous, 4 -> 6 a pipelined chunk) after the
    arrival and cuts the padding off before the return: no padding
    travels, so the bytes are the plain path's."""
    cfg = get_config(arch).reduced()
    for kind, n in (("decode", 6), ("prefill", 13)):
        got = _ep_copy_bytes(cfg, kind, n, kernels, overlap)
        want = moe_layer_count(cfg) * roofline.ep_round_bytes(cfg, n, 4)
        assert got == want > 0, (kind, got, want)


def test_ep_round_bytes_counts_buckets_not_routing():
    """The bytes follow the bucket shapes only: 2 exchanges x n(n-1) pairs
    x (E/n, C, d) at C = capacity(ceil(T / n)), in the config's dtype;
    one rank and a dense config copy nothing."""
    from repro_torch.models.moe import capacity
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    m = cfg.moe
    c = capacity(32, m.top_k, m.n_experts, m.capacity_factor)
    assert roofline.ep_round_bytes(cfg, 128, 4) == 2 * 12 * 4 * c * 4096 * 2
    c8 = capacity(16, m.top_k, m.n_experts, m.capacity_factor)
    assert roofline.ep_round_bytes(cfg, 125, 8) == 2 * 56 * 2 * c8 * 4096 * 2
    assert roofline.ep_round_bytes(cfg, 128, 1) == 0
    assert roofline.ep_round_bytes(get_config("gemma-7b"), 128, 4) == 0


_DIGESTS = {  # sha256 of the leaves' bytes, seed 3, before the meta branch
    "phi3.5-moe-42b-a6.6b": "f6bc535f2cddacdd1a2795ded3ef42bb",
    "mamba2-1.3b": "3937f35c8860dd9aa60d660400c41a16",
    "deepseek-v3-671b": "b8c019ca4c33810007ae92513b479637",
    "seamless-m4t-large-v2": "838d891b2f4670fbbda011cd78848505",
}


@pytest.mark.parametrize("arch", sorted(_DIGESTS))
def test_init_params_on_meta_and_cpu_numbers_unchanged(arch):
    cfg = get_config(arch).reduced()
    cpu = tree_leaves(init_params(cfg, seed=3, device="cpu"))
    h = hashlib.sha256()
    for t in cpu:
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:32] == _DIGESTS[arch]
    meta = tree_leaves(init_params(cfg, seed=3, device="meta"))
    assert [(t.shape, t.dtype) for t in meta] == [(t.shape, t.dtype)
                                                  for t in cpu]
    assert all(t.device.type == "meta" for t in meta)
    # Full width on meta allocates nothing.
    full = tree_leaves(init_params(get_config(arch), device="meta"))
    assert all(t.is_meta for t in full)

"""The port's remaining families against the JAX reference, on the CPU.

mamba2 (SSM), zamba2 (Mamba2 blocks and one shared attention block),
qwen2-vl (M-RoPE, patch embeddings) and SeamlessM4T (encoder-decoder with
frame embeddings), all reduced (fp32; zamba2 at 3 layers of period 2):
configs, ``apply_mrope``, the param and cache trees, ``Model`` logits,
greedy streams through ``ContinuousEngine`` (one-shot, chunked, slot
reuse) and ``ServingEngine`` (frames), and ``decode_attn``'s geometry at
the full-width shapes these families give it. Weights come from the JAX
package through ``repro_torch.bridge``; other inputs are made with numpy
from a seed. Tolerances: 1e-5 for fp32 M-RoPE, 1e-4 for model logits (sums
over d = 256 and several layers in another order); streams are identical.
One test runs the frontends in bf16, at the repo's bf16 tolerance of 2e-2
(relative to the largest logit).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.configs import ModelConfig, cut_depth, get_config  # noqa: E402
from repro_torch.kernels.decode_attn import geometry  # noqa: E402
from repro_torch.models import Model, init_params  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["mamba2-1.3b", "zamba2-7b", "qwen2-vl-7b", "seamless-m4t-large-v2"]
SSM, HYBRID, VLM, AUDIO = ARCHS
LOGITS = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these paths run many small ops, and several
    test workers on one host make every multi-threaded op wait for
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX params of the reduced config (seed 0) as numpy leaves, made once
    per arch (jitted: the eager init takes seconds)."""
    cfg = jax_get_config(arch).reduced()
    return jax.tree.map(np.asarray,
                        jax.jit(JaxModel(cfg).init)(jax.random.PRNGKey(0)))


def _jax(arch):
    return (JaxModel(jax_get_config(arch).reduced()),
            jax.tree.map(jnp.asarray, _weights(arch)))


def _port(arch):
    return (Model(get_config(arch).reduced(), device="cpu"),
            bridge.to_torch(_weights(arch), device="cpu"))


def _streams(reqs):
    return [list(map(int, r.out_tokens)) for r in reqs]


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field equals the reference's, full and reduced (SSM dims cut to
    d_state <= 16, head_dim 32, chunk 32; the hybrid at 3 layers of period
    2; M-RoPE (8, 12, 12); frontend_dim <= 128; <= 2 encoder layers), and so
    do the layer kinds, the encoder-decoder flag and the segments."""
    for cut in (lambda c: c, lambda c: c.reduced()):
        ours, ref = cut(get_config(arch)), cut(jax_get_config(arch))
        for f in dataclasses.fields(ModelConfig):
            assert _norm(getattr(ours, f.name)) == _norm(
                getattr(ref, f.name)), f.name
        assert ours.layer_kinds() == ref.layer_kinds()
        assert ours.is_encoder_decoder == ref.is_encoder_decoder
        assert tt.segments_of(ours) == [
            tt.Segment(s.kinds, s.count) for s in jt.segments_of(ref)]


def test_registry_and_cuts():
    """The registry holds the reference's ten archs. ``cut_depth`` keeps a
    hybrid stack's period phase (8 layers of zamba2: one MMMMMMA block and
    an M remainder, as the reference's segments of the same depth) and
    cuts an encoder-decoder's decoder only."""
    from repro.configs import ARCH_IDS as JAX_IDS
    from repro_torch.configs import ARCH_IDS
    assert set(ARCH_IDS) == set(JAX_IDS)
    full_j = jax_get_config(HYBRID)
    for n in (8, 14, 21):
        cfg = cut_depth(get_config(HYBRID), n)
        ref = dataclasses.replace(full_j, n_layers=n)
        assert cfg.layer_kinds() == ref.layer_kinds()
        assert tt.segments_of(cfg) == [
            tt.Segment(s.kinds, s.count) for s in jt.segments_of(ref)]
    cfg = cut_depth(get_config(AUDIO), 4)
    assert (cfg.n_layers, cfg.n_encoder_layers) == (4, 24)
    with pytest.raises(KeyError):
        get_config("mamba3-unknown")


def test_apply_mrope_matches_jax():
    """Three different position streams (temporal, height, width) over the
    reduced sections (8, 12, 12) of head_dim 64, and the text case where
    all three equal the positions (then M-RoPE is RoPE)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    pos3 = np.stack([rng.integers(0, 50, (2, 5)) for _ in range(3)])
    sec = (8, 12, 12)
    want = jax.jit(jl.apply_mrope, static_argnums=(2, 3))(
        x, pos3.astype(np.int32), 1e6, sec)
    got = tl.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6,
                         sec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pos = torch.from_numpy(pos3[0])
    np.testing.assert_allclose(
        tl.apply_mrope(torch.from_numpy(x), pos[None].expand(3, 2, 5), 1e6,
                       sec).numpy(),
        tl.apply_rope(torch.from_numpy(x), pos, 1e6).numpy(), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_trees_match_jax(arch):
    """The port's seeded init and per-slot cache have the reference's leaf
    paths, shapes and dtypes: M leaves (``ln``, ``mamba``), an empty dict
    at an A position, the hybrid's ``shared`` block, C leaves (``ln_x``,
    ``xattn``), the ``encoder`` and ``frontend_proj``; M caches (``conv``,
    ``state`` fp32) and C caches (``k``, ``v``, ``xk``, ``xv`` of
    ``src_len``)."""
    cfg_j = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    src = 6 if cfg.is_encoder_decoder else 0
    for ours, ref in (
            (init_params(cfg, seed=0, device="cpu"),
             jax.eval_shape(lambda: JaxModel(cfg_j).init(
                 jax.random.PRNGKey(0)))),
            (tt.init_cache(cfg, 3, 40, src_len=src, per_slot_len=True,
                           device="cpu"),
             jax.eval_shape(lambda: jt.init_cache(
                 cfg_j, 3, 40, src_len=src, per_slot_len=True)))):
        paths = bridge.leaf_paths(ours)
        assert sorted(map(str, paths)) == sorted(
            map(str, bridge.leaf_paths(ref)))
        for path in paths:
            a, b = ref, ours
            for key in path:
                a, b = a[key], b[key]
            assert tuple(b.shape) == tuple(a.shape), path
            assert str(b.dtype).split(".")[-1] == str(a.dtype), path
    if arch == HYBRID:
        assert init_params(cfg, device="cpu")["segments"][0][2] == {}


def _prefill_inputs(arch, cfg, rng, b, s):
    toks = rng.integers(1, cfg.vocab, (b, s)).astype(np.int32)
    if arch == VLM:
        emb = rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)
        return {"embeds": emb}
    inputs = {"tokens": toks}
    if arch == AUDIO:
        inputs["frames"] = rng.standard_normal(
            (b, 9, cfg.frontend_dim)).astype(np.float32)
    return inputs


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_match_jax(arch):
    """A batch-2 prefill (tokens; qwen2-vl's patch embeddings; SeamlessM4T's
    frames and tokens) then four greedy decode steps, one with row 1
    frozen: logits within 1e-4 of the JAX ``Model``'s, and the caches'
    fill levels alike."""
    mj, pj = _jax(arch)
    mt, pt = _port(arch)
    cfg = mt.cfg
    rng = np.random.default_rng(3)
    inputs = _prefill_inputs(arch, cfg, rng, 2, 7)
    src = inputs["frames"].shape[1] if "frames" in inputs else 0
    cj = mj.init_cache(2, 16, src_len=src, per_slot_len=True)
    ct = mt.init_cache(2, 16, src_len=src, per_slot_len=True)
    lj, cj = jax.jit(mj.prefill)(pj, jax.tree.map(jnp.asarray, inputs), cj)
    lt, ct = mt.prefill(pt, {k: torch.from_numpy(v)
                             for k, v in inputs.items()}, ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
    dec = jax.jit(mj.decode_step)
    tok = np.array(jnp.argmax(lj[:, -1:, :cfg.vocab], -1), np.int32)
    for step in range(4):
        mask = np.array([True, step != 1])
        lj, cj = dec(pj, jnp.asarray(tok), cj, jnp.asarray(mask))
        lt, ct = mt.decode_step(pt, torch.from_numpy(tok).long(), ct,
                                torch.from_numpy(mask))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGITS)
        tok = np.array(jnp.argmax(lj[:, :, :cfg.vocab], -1), np.int32)
    assert ct["len"].tolist() == np.asarray(cj["len"]).tolist() == [11, 10]
    for path in bridge.leaf_paths(ct["segments"]):
        a, b = cj["segments"], ct["segments"]
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **LOGITS,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", [HYBRID, VLM, AUDIO])
def test_bf16_logits_within_bf16_of_jax(arch):
    """The reduced configs in bf16. The port casts the fp32 patch
    embeddings or frames to bf16 before the frontend projection; the
    reference promotes fp32 frames against bf16 weights, so its encoder
    runs in fp32 (its embeds prefill cannot take fp32 embeds in bf16: the
    promoted K/V do not fit its bf16 cache, so it is given them in bf16).
    zamba2 (tokens only, no frontend) is the control: bf16's rounding in
    two orders of summation. Prefill and 16 decode steps, both fed the
    reference's token: every logit within 2e-2 of the largest. Prints the
    largest gap and the first step whose argmax parts (``-s``)."""
    cfg_j = dataclasses.replace(jax_get_config(arch).reduced(),
                                dtype="bfloat16")
    mj = JaxModel(cfg_j)
    w = jax.tree.map(np.asarray, jax.jit(mj.init)(jax.random.PRNGKey(0)))
    pj = jax.tree.map(jnp.asarray, w)
    mt = Model(dataclasses.replace(get_config(arch).reduced(),
                                   dtype="bfloat16"), device="cpu")
    pt = bridge.to_torch(w, device="cpu")
    inputs = _prefill_inputs(arch, mt.cfg, np.random.default_rng(3), 2, 7)
    src = inputs["frames"].shape[1] if "frames" in inputs else 0
    cj = mj.init_cache(2, 16, src_len=src, per_slot_len=True)
    ct = mt.init_cache(2, 16, src_len=src, per_slot_len=True)
    ref_in = {k: jnp.asarray(v, jnp.bfloat16 if k == "embeds" else None)
              for k, v in inputs.items()}
    lj, cj = jax.jit(mj.prefill)(pj, ref_in, cj)
    lt, ct = mt.prefill(pt, {k: torch.from_numpy(v)
                             for k, v in inputs.items()}, ct)
    dec = jax.jit(mj.decode_step)
    gaps, parts = [], None
    for step in range(17):
        want = np.asarray(lj, np.float32)[:, -1, :cfg_j.vocab]
        got = lt.float().numpy()[:, -1, :cfg_j.vocab]
        gaps.append(np.abs(got - want).max() / np.abs(want).max())
        assert gaps[-1] <= 2e-2, (step, gaps[-1])
        tok = want.argmax(-1)[:, None].astype(np.int32)
        if parts is None and (got.argmax(-1) != tok[:, 0]).any():
            parts = step
        lj, cj = dec(pj, jnp.asarray(tok), cj)
        lt, ct = mt.decode_step(pt, torch.from_numpy(tok).long(), ct)
    print(f"{arch} bf16: largest logit gap {max(gaps):.4g} of the largest "
          f"logit; first parting step {parts} (0 = prefill)")


def test_first_chunk_zeroes_the_slot_state():
    """``prefill_chunk_slot(first=True)`` zeroes every leaf of the slot's
    row before the prefill (``cache_leaves``), SSM conv window and state
    included: a row left full of another request's state prefills to the
    logits and the row of a fresh cache."""
    mt, pt = _port(SSM)
    toks = {"tokens": torch.tensor([[5, 9, 2, 7, 1]])}
    fresh = mt.init_cache(2, 16, per_slot_len=True)
    lf, _ = mt.prefill_chunk_slot(pt, toks, fresh, 1, first=True, cap=16)
    dirty = mt.init_cache(2, 16, per_slot_len=True)
    for leaf in tt.cache_leaves(dirty):
        leaf.normal_()
    dirty["len"].fill_(9)
    ld, _ = mt.prefill_chunk_slot(pt, toks, dirty, 1, first=True, cap=16)
    assert torch.equal(lf, ld)
    for a, b in zip(tt.cache_leaves(fresh), tt.cache_leaves(dirty)):
        assert torch.equal(a[:, 1], b[:, 1])
    assert dirty["len"].tolist() == [9, 5]


# -- engines -------------------------------------------------------------------

def _poisson(m, seed, n=6):
    """Ragged prompts (5-12 tokens), 4-16 new tokens, arrivals at rate 0.7:
    more requests than slots, so slots are reused and vacant ones decode."""
    rng = np.random.default_rng(seed)
    reqs = m.poisson_requests(rng, n, 0.7, 500, 12, 4, 16)
    for r in reqs:
        r.prompt = [int(t) for t in r.prompt[:int(rng.integers(5, 13))]]
    return reqs


def _chunk_requests(m):
    """``tests/test_chunked_prefill.py``'s stream: a 16-token prompt spans
    several chunks, arrivals are staggered."""
    return [m.Request(prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=5,
                      arrival=0.0),
            m.Request(prompt=[9, 8, 7], max_new_tokens=4, arrival=1.0),
            m.Request(prompt=list(range(1, 17)), max_new_tokens=6,
                      arrival=2.0),
            m.Request(prompt=[5, 5, 5, 5, 5], max_new_tokens=3,
                      arrival=9.0)]


def _isolation_requests(m):
    """``tests/test_continuous.py:84``'s stream: one slot, reused."""
    return [m.Request(prompt=[9, 9, 9, 9], max_new_tokens=3, arrival=0.0),
            m.Request(prompt=[1, 2, 3, 4], max_new_tokens=4, arrival=4.0)]


@pytest.mark.parametrize("arch", [SSM, HYBRID, VLM])
def test_continuous_streams_match_jax(arch):
    """A Poisson stream through 3 slots, one-shot admission: the port's
    ``ContinuousEngine`` emits the JAX engine's streams."""
    mj, pj = _jax(arch)
    want = _streams(jserving.ContinuousEngine(
        mj, pj, batch_slots=3, cache_cap=40).serve(_poisson(jserving, 3)))
    mt, pt = _port(arch)
    got = _streams(tserving.ContinuousEngine(
        mt, pt, batch_slots=3, cache_cap=40,
        config=tserving.EngineConfig(kernels=True)).serve(
            _poisson(tserving, 3)))
    assert got == want


@pytest.mark.parametrize("arch,chunk", [(SSM, 2), (SSM, 4), (HYBRID, 4)],
                         ids=["mamba2-chunk2", "mamba2-chunk4",
                              "zamba2-chunk4"])
def test_chunked_streams_match_jax(arch, chunk):
    """Chunked admission (the SSM state and the shared block's KV cache
    continue across chunks): the port's streams equal the JAX engine's
    and the one-shot ones (``tests/test_chunked_prefill.py``)."""
    mj, pj = _jax(arch)
    want = _streams(jserving.ContinuousEngine(
        mj, pj, 2, 48, config=jserving.EngineConfig(
            prefill_chunk=chunk)).serve(_chunk_requests(jserving)))
    mt, pt = _port(arch)
    one_shot = _streams(tserving.ContinuousEngine(mt, pt, 2, 48).serve(
        _chunk_requests(tserving)))
    got = _streams(tserving.ContinuousEngine(
        mt, pt, 2, 48, config=tserving.EngineConfig(
            prefill_chunk=chunk, kernels=True)).serve(
                _chunk_requests(tserving)))
    assert got == want == one_shot


@pytest.mark.parametrize("chunk", [None, 2], ids=["one_shot", "chunk2"])
def test_ssm_slot_reuse_isolation(chunk):
    """A reused slot does not inherit its previous occupant's conv window
    or SSD state: the second request's stream equals a fresh engine's, and
    the JAX engine's (``tests/test_continuous.py:84``)."""
    mj, pj = _jax(SSM)
    cfg_j = jserving.EngineConfig(prefill_len=4, prefill_chunk=chunk)
    want = _streams(jserving.ContinuousEngine(
        mj, pj, batch_slots=1, cache_cap=32, config=cfg_j).serve(
            _isolation_requests(jserving)))
    mt, pt = _port(SSM)
    config = tserving.EngineConfig(prefill_len=4, prefill_chunk=chunk)
    got = _streams(tserving.ContinuousEngine(
        mt, pt, batch_slots=1, cache_cap=32, config=config).serve(
            _isolation_requests(tserving)))
    solo = tserving.ContinuousEngine(mt, pt, batch_slots=1, cache_cap=32,
                                     config=config).serve(
        [tserving.Request(prompt=[1, 2, 3, 4], max_new_tokens=4)])
    assert got == want
    assert got[1] == _streams(solo)[0]


@pytest.mark.parametrize("src_len", [0, 12], ids=["src_len0", "src_len12"])
def test_encdec_serving_engine_matches_jax(src_len):
    """SeamlessM4T through ``ServingEngine`` with frames (kernel path and
    plain): the JAX engine's streams, whether ``src_len`` is 0 (the
    reference's launcher: the cross cache is sized from the frames) or set
    to the frames' length."""
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((3, 12, 128)).astype(np.float32)

    def reqs(m):
        return [m.Request(prompt=[1, 2, 3], max_new_tokens=6),
                m.Request(prompt=[4, 5], max_new_tokens=4),
                m.Request(prompt=[7, 8, 9, 10], max_new_tokens=5)]
    mj, pj = _jax(AUDIO)
    want = _streams(jserving.ServingEngine(
        mj, pj, batch_slots=3, cache_cap=32, src_len=src_len).serve(
            reqs(jserving), frames=frames))
    mt, pt = _port(AUDIO)
    for kernels in (True, False):
        eng = tserving.ServingEngine(mt, pt, batch_slots=3, cache_cap=32,
                                     src_len=src_len, kernels=kernels)
        assert _streams(eng.serve(reqs(tserving), frames=frames)) == want
    with pytest.raises(ValueError, match="src_len"):
        tserving.ServingEngine(mt, pt, batch_slots=3, cache_cap=32,
                               src_len=5).serve(reqs(tserving), frames=frames)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserving.ContinuousEngine(mt, pt, batch_slots=2, cache_cap=32)
    assert mt.chunkable_len(32) == 0
    assert _port(SSM)[0].chunkable_len(32) is None


def test_launch_new_families_on_cpu(capsys):
    """The launcher's static encoder-decoder run on seeded frames and a
    chunked hybrid stream; ``--mesh`` refuses a new family, which has no
    experts to shard."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", AUDIO, "--reduced", "--device", "cpu",
                       "--kernels", "--batch", "2", "--cache-cap", "32",
                       "--max-new-tokens", "3", "--prompt-len", "6"]) == 0
    assert serve.main(["--arch", HYBRID, "--reduced", "--device", "cpu",
                       "--kernels", "--batch", "2", "--cache-cap", "32",
                       "--max-new-tokens", "3", "--num-requests", "2",
                       "--arrival-rate", "0.5", "--prefill-chunk", "4"]) == 0
    out = capsys.readouterr().out
    assert "static batch of 2" in out and "tokens in" in out
    with pytest.raises(SystemExit, match="no MoE layers"):
        serve.main(["--arch", VLM, "--reduced", "--device", "cpu",
                    "--mesh", "2", "--arrival-rate", "0.5"])


def test_new_families_serve_alone():
    """Only the encoder-decoder serves alone: colocating SeamlessM4T raises
    ValueError (the engines pass no frames), while mamba2 colocates
    (``test_torch_colocated_families*.py`` serve it). Expert parallelism
    and replication refuse mamba2 as any model without experts."""
    from repro_torch.distributed.group import LocalGroup
    from repro_torch.serving.distributed import distribute
    mt, pt = _port(SSM)
    tserving.ColocatedEngine(mt, mt, pt, pt)
    ma, pa = _port(AUDIO)
    with pytest.raises(ValueError, match="no frames"):
        tserving.ColocatedEngine(mt, ma, pt, pa)
    with pytest.raises(ValueError, match="no MoE layers"):
        distribute(mt, LocalGroup(2, "cpu"))
    eng = tserving.ContinuousEngine(mt, pt, batch_slots=2, cache_cap=16)
    with pytest.raises(ValueError, match="no experts"):
        eng.adopt_replication([2, 1])


# -- decode_attn at the new shapes ---------------------------------------------

@pytest.mark.parametrize("h,hkv,d,want", [
    (32, 32, 112, dict(chunks=14, lpp=16)),    # zamba2's shared block
    (28, 4, 128, dict(chunks=16, lpp=16)),     # qwen2-vl, G = 7
    (16, 16, 64, dict(chunks=8, lpp=8)),       # SeamlessM4T
], ids=["zamba2_D112", "qwen2vl_G7", "seamless_D64"])
def test_decode_attn_geometry_at_the_families_shapes(h, hkv, d, want):
    """The full-width bf16 decode shapes at 8 slots and a cache of 512:
    D = 112 fills 14 of 16 lanes a position (the first chunk count that is
    not a power of two); G = 7 is accepted (``csrc`` runs its G = 8 body
    with one dead head). The shared memory matches ``csrc``'s layout for
    the real G."""
    geo = geometry(8, h, hkv, 512, d, torch.bfloat16)
    assert {k: geo[k] for k in want} == want
    g = h // hkv
    row = 2 * d * 2
    fixed = 4 * (8 * g * (d + 2) + 2 * geo["split"] * g)
    assert geo["smem"] == geo["buffers"] * geo["tile"] * row + fixed
    assert geo["work"] == 8 * hkv * geo["split"] * g * (d + 2)

"""The port's training against the JAX reference, on the CPU.

``cross_entropy``, ``Model.train_logits`` with its loss and grads for the
ten reduced archs (fp32; B 2, S 16; frames for SeamlessM4T, patch embeds
for qwen2-vl), the flash branch's grads, ``mamba_block``'s grads over a
zero-padded chunk, AdamW, ``SyntheticLMData``, checkpoints both ways and
``train_loop``. Weights come from the JAX package through
``repro_torch.bridge``; other inputs are made with numpy from a seed. Grads
are compared leaf by leaf in JAX's flatten order (``bridge.tree_leaves``).

Tolerances: a loss within 1e-5 relative; a grad leaf within 1e-5 + 1e-4 x
its largest magnitude (sums over several layers in another order);
optimizer state within 1e-6 x the leaf's largest magnitude, bf16 also
within one bf16 step of each element (2^-8 relative: a last-bit difference
in fp32 may round either way); the loop's
metrics within 1e-4 relative over 5 steps. The port's remat grads equal its
plain grads exactly, and data and checkpoints are byte-equal.
"""

import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import cross_entropy as jax_cross_entropy  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import LocalGroup  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import Model, ParallelContext, cross_entropy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.moe import ReplicationSpec  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.training.loop import loss_and_grads  # noqa: E402

B, S = 2, 16
LOSS_RTOL = 1e-5
MOE = "phi3.5-moe-42b-a6.6b"
CASES = list(ARCH_IDS) + ["qwen2-vl-7b+embeds"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small ops, several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX params of the reduced config (seed 0) as numpy leaves."""
    cfg = jax_get_config(arch).reduced()
    return jax.tree.map(np.asarray,
                        jax.jit(JaxModel(cfg).init)(jax.random.PRNGKey(0)))


def _batch(cfg, case, seed=0):
    """Next-token batch made with numpy: tokens, plus frames (an
    encoder-decoder) or patch embeds (the "+embeds" case)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    if case.endswith("+embeds"):
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    return batch


def _jax_loss(model):
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch, remat=False)
        ce = jax_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                               cfg.vocab)
        return ce + 0.01 * aux
    return loss_fn


def _port_loss(model, remat=False):
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.train_logits(params, batch, remat=remat)
        ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:], cfg.vocab)
        return ce + 0.01 * aux, {}
    return loss_fn


def _close_leaves(got, want, what):
    """Each grad leaf within 1e-5 + 1e-4 x its largest magnitude."""
    got, want = bridge.tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        tol = 1e-5 + 1e-4 * float(np.abs(w).max(initial=0.0))
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= tol, f"{what}: leaf {i} {w.shape}: {err} > {tol}"


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- cross_entropy -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_and_logit_grads_match_jax(dtype):
    """Padded vocab (500 of 512 slots, the padded ones at -1e30): value and
    logit grads, fp32 and bf16 logits."""
    rng = np.random.default_rng(0)
    vocab, vpad = 500, 512
    logits = (rng.standard_normal((B, 7, vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (B, 7)).astype(np.int32)
    jl_ = jnp.asarray(logits).astype(dtype)
    want, want_g = jax.value_and_grad(jax_cross_entropy)(
        jl_, jnp.asarray(labels), vocab)
    t = bridge.leaf_to_torch(np.asarray(jl_), device="cpu").requires_grad_(True)
    got = cross_entropy(t, torch.from_numpy(labels), vocab)
    (got_g,) = torch.autograd.grad(got, t)
    assert got_g.dtype == t.dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    want_g = np.asarray(want_g, np.float32)
    tol = (1e-7 if dtype == "float32" else 2e-2) * np.abs(want_g).max()
    assert np.abs(got_g.float().numpy() - want_g).max() <= tol
    assert np.all(got_g[..., vocab:].float().numpy() == 0)


# -- train_logits, loss and grads --------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_train_loss_and_grads_match_jax(case):
    """``train_logits`` + next-token CE + 0.01 aux, and its grads by leaf,
    against ``jax.value_and_grad`` on the same weights and batch."""
    arch = case.split("+")[0]
    cfg = get_config(arch).reduced()
    jmodel = JaxModel(jax_get_config(arch).reduced())
    batch = _batch(cfg, case)
    jparams = jax.tree.map(jnp.asarray, _weights(arch))
    want, want_g = jax.jit(jax.value_and_grad(_jax_loss(jmodel)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = Model(cfg, device="cpu")
    loss, _, grads = loss_and_grads(_port_loss(model), bridge.to_torch(
        _weights(arch), device="cpu"), _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    _close_leaves(grads, want_g, case)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_grads_equal_plain_grads(arch):
    """Each block under ``torch.utils.checkpoint`` gives the plain grads,
    bit for bit (zamba2's shared block: the sum over its uses)."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = bridge.to_torch(_weights(arch), device="cpu")
    batch = _torch_batch(_batch(cfg, arch, seed=1))
    plain = loss_and_grads(_port_loss(model), params, batch)
    remat = loss_and_grads(_port_loss(model, remat=True), params, batch)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(bridge.tree_leaves(plain[2]),
                    bridge.tree_leaves(remat[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [None, 300])
def test_flash_attention_grads_match_jax(window):
    """``attention_core``'s flash branch (Sq = Sk = 2100 > 4,194,304 / Sk,
    2 heads of 16, causal, with and without a window): the output and the
    q, k, v grads of a weighted sum."""
    rng = np.random.default_rng(3)
    n = 2100
    assert n * n > tl.FLASH_ABOVE
    q, k, v, w = (rng.standard_normal((1, n, 2, 16)).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        out = jl.attention_core(q, k, v, causal_offset=0, window=window,
                                valid_len=None)
        return jnp.sum(out * w)
    want, want_g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tl.attention_core(*ts, causal_offset=0, valid_len=None,
                            window=window)
    got = torch.sum(out * torch.from_numpy(w))
    got_g = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, wg in zip(got_g, want_g):
        wg = np.asarray(wg)
        assert np.abs(g.numpy() - wg).max() <= 1e-5 + 1e-4 * np.abs(wg).max()


def test_mamba_block_grads_over_a_padded_chunk_match_jax():
    """mamba2's block on 40 positions (chunk 32: the last chunk zero-padded)
    with no cache, the train form: output and grads of every leaf and of
    the input."""
    arch = "mamba2-1.3b"
    cfg = get_config(arch).reduced()
    assert S < cfg.ssm.chunk < 40 < 2 * cfg.ssm.chunk
    p_np = jax.tree.map(lambda t: t[0], _weights(arch)["segments"][0][0][
        "mamba"])
    x = np.random.default_rng(4).standard_normal(
        (B, 40, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    jcfg = jax_get_config(arch).reduced()

    def jloss(p, x):
        return jnp.sum(jssm.mamba_block(p, x, jcfg, None)[0] * w)
    want, (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, p_np), x)
    p = bridge.to_torch(p_np, device="cpu")
    leaves = bridge.tree_leaves(p)
    xt = torch.from_numpy(x).requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    got = torch.sum(tssm.mamba_block(p, xt, cfg) * torch.from_numpy(w))
    grads = torch.autograd.grad(got, leaves + [xt])
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    _close_leaves(bridge.tree_unflatten(p, grads[:-1]), want_gp, "mamba")
    _close_leaves([grads[-1]], [want_gx], "x")


def test_train_logits_refuses_kernels_expert_parallel_and_replicas():
    """The CUDA ``moe_gmm`` has no backward, sharded training is not
    ported, and replicated experts would drift apart: each raises instead
    of training wrong."""
    cfg = get_config(MOE).reduced()
    params = bridge.to_torch(_weights(MOE), device="cpu")
    batch = _torch_batch(_batch(cfg, MOE))
    with pytest.raises(ValueError, match="no backward"):
        Model(cfg, device="cpu").with_kernels().train_logits(params, batch)
    pc = ParallelContext(group=LocalGroup(2, "cpu"), moe_impl="ep")
    with pytest.raises(ValueError, match="expert-parallel"):
        Model(cfg, device="cpu", pc=pc).train_logits(params, batch)
    spec = ReplicationSpec.from_counts([2] + [1] * (cfg.moe.n_experts - 1))
    with pytest.raises(ValueError, match="drift apart"):
        Model(cfg, device="cpu", replication=spec).train_logits(
            params, batch)


# -- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(param_dtype, state_dtype, monkeypatch):
    """Three steps from the same grads: warmup 2 (steps 1-2 inside it, 3
    past), the global-norm clip active (norm ~30 against 1.0), a stacked
    (count, d) norm leaf (decayed: ndim > 1, as in the reference), a
    vector (not decayed), a matrix; every leaf updated in slices of 7
    elements (the last one ragged)."""
    monkeypatch.setattr(training.optim, "SLICE", 7)
    rng = np.random.default_rng(6)
    shapes = {"norm": (2, 8), "bias": (8,), "w": (8, 4, 3)}

    def tree(scale):
        return {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in shapes.items()}
    p0 = tree(1.0)
    grads = [tree(3.0 / (i + 1)) for i in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, state_dtype=state_dtype)
    jcfg = jtraining.AdamWConfig(**cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype), p0)
    jopt = jtraining.adamw_init(jp, jcfg)
    tcfg = training.AdamWConfig(**cfg)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    topt = training.adamw_init(tp, tcfg)
    jupd = jax.jit(functools.partial(jtraining.adamw_update, cfg=jcfg))
    for g in grads:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(param_dtype), g)
        jp, jopt = jupd(jp, jg, jopt)
        tp, topt = training.adamw_update(
            tp, bridge.to_torch(jax.tree.map(np.asarray, jg), device="cpu"), topt, tcfg)
        assert topt["step"].dtype == torch.int32
        assert int(topt["step"]) == int(jopt["step"])
        for got, want, dt in ((tp, jp, param_dtype),
                              (topt["m"], jopt["m"], state_dtype),
                              (topt["v"], jopt["v"], state_dtype)):
            step = 0.0 if dt == "float32" else 2.0 ** -8
            for a, b in zip(bridge.tree_leaves(got), jax.tree.leaves(want)):
                assert str(a.dtype) == f"torch.{dt}"
                b = np.asarray(b, np.float32)
                err = np.abs(a.float().numpy() - b)
                tol = step * np.abs(b) + 1e-6 * np.abs(b).max()
                assert np.all(err <= tol), (err - tol).max()


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_data_equals_reference(seed):
    """Tokens and frames byte-equal to the reference's, batch by batch."""
    kw = dict(vocab=32064, seq_len=24, batch=3, seed=seed, frames_dim=8,
              frames_len=5)
    ours, ref = training.SyntheticLMData(**kw), jtraining.SyntheticLMData(**kw)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b) == ["frames", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


# -- checkpoints -------------------------------------------------------------

def _params(dtype):
    """gemma-7b's reduced params (the reference's round-trip arch) as
    numpy leaves in ``dtype``."""
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(dtype)),
        _weights("gemma-7b"))


def test_leaf_order_is_jax_flatten_order():
    """``bridge.tree_leaves`` walks the params and an optimizer state
    (dict keys not inserted sorted) in ``jax.tree.leaves``' order; the
    manifest's treedef is the reference's string."""
    for arch in ("deepseek-v3-671b", "zamba2-7b"):
        tree = {"m": _weights(arch), "v": _weights(arch),
                "step": np.int32(3)}
        tree = {k: tree[k] for k in ("v", "step", "m")}
        want = jax.tree.leaves(tree)
        got = bridge.tree_leaves(bridge.to_torch(tree, device="cpu"))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        assert training.checkpoint._treedef(bridge.to_torch(tree, device="cpu")) == str(
            jax.tree.structure(tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip(tmp_path, dtype):
    params = bridge.to_torch(_params(dtype), device="cpu")
    opt = training.adamw_init(params, training.AdamWConfig())
    tree = {"params": params, "opt": opt}
    training.save_checkpoint(str(tmp_path), tree, step=7)
    zeros = bridge.map_tree(torch.zeros_like, tree)
    back = training.restore_checkpoint(str(tmp_path), zeros)
    assert training.checkpoint_step(str(tmp_path)) == 7
    for a, b in zip(bridge.tree_leaves(tree), bridge.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_port(tmp_path, dtype):
    """A reference-written checkpoint (bf16 leaves as ``|V2``) restores
    leaf for leaf; the port writes the same files (bytes of every leaf,
    the manifest)."""
    src = _params(dtype)
    jtraining.save_checkpoint(str(tmp_path / "jax"), jax.tree.map(
        jnp.asarray, src), step=3)
    like = bridge.map_tree(torch.zeros_like, bridge.to_torch(src, device="cpu"))
    back = training.restore_checkpoint(str(tmp_path / "jax"), like)
    for a, b in zip(bridge.tree_leaves(back), jax.tree.leaves(src)):
        assert str(a.dtype) == f"torch.{dtype}"
        assert a.view(torch.int16 if dtype == "bfloat16" else a.dtype
                      ).numpy().tobytes() == np.asarray(b).tobytes()
    training.save_checkpoint(str(tmp_path / "port"), back, step=3)
    files = {}
    for who in ("jax", "port"):
        with open(tmp_path / who / "manifest.json") as f:
            manifest = json.load(f)
        with np.load(tmp_path / who / "arrays.npz") as data:
            files[who] = manifest, {k: (data[k].dtype.str, data[k].tobytes())
                                    for k in data.files}
    assert files["jax"] == files["port"]
    if dtype == "bfloat16":
        assert files["jax"][1]["leaf_0"][0] == "|V2"


def test_port_checkpoint_restores_into_jax(tmp_path):
    src = _params("float32")
    training.save_checkpoint(str(tmp_path), bridge.to_torch(src, device="cpu"), step=5)
    zeros = jax.tree.map(jnp.zeros_like, src)
    back = jtraining.restore_checkpoint(str(tmp_path), zeros)
    assert jax.tree.structure(back) == jax.tree.structure(src)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(src)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jtraining.checkpoint.checkpoint_step(str(tmp_path)) == 5


# -- the loop ----------------------------------------------------------------

def test_train_loop_matches_jax():
    """Reduced phi3.5-MoE from the same weights on the same data, 5 steps
    (lr 1e-3, warmup 2): ce, aux and loss within 1e-4 relative at each."""
    opt = dict(lr=1e-3, warmup_steps=2)
    data = dict(vocab=get_config(MOE).reduced().vocab, seq_len=S, batch=4,
                seed=2)
    _, want = jtraining.train_loop(
        JaxModel(jax_get_config(MOE).reduced()),
        jtraining.SyntheticLMData(**data), steps=5,
        opt_cfg=jtraining.AdamWConfig(**opt), log_every=1,
        params=jax.tree.map(jnp.asarray, _weights(MOE)))
    state, got = training.train_loop(
        Model(get_config(MOE).reduced(), device="cpu"),
        training.SyntheticLMData(**data), steps=5,
        opt_cfg=training.AdamWConfig(**opt), log_every=1,
        params=bridge.to_torch(_weights(MOE), device="cpu"))
    assert state.step == 5 and int(state.opt["step"]) == 5
    assert [h["step"] for h in got] == [h["step"] for h in want] == [
        0, 1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("ce", "aux", "loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)


def test_train_loss_decreases():
    """The reference's check (``tests/test_training_serving.py``) on the
    port: reduced phi4-mini, 60 steps."""
    cfg = get_config("phi4-mini-3.8b").reduced()
    data = training.SyntheticLMData(cfg.vocab, seq_len=64, batch=8, seed=0)
    _, hist = training.train_loop(
        Model(cfg, device="cpu"), data, steps=60,
        opt_cfg=training.AdamWConfig(lr=1e-3, warmup_steps=20), log_every=5)
    first = np.mean([h["ce"] for h in hist[:3]])
    last = np.mean([h["ce"] for h in hist[-3:]])
    assert last < first * 0.9, f"loss did not decrease: {first} -> {last}"


def test_moe_train_loss_decreases_with_aux():
    """The reference's MoE check on the port: reduced phi3.5-MoE, 40
    steps; the aux loss finite at every logged step."""
    cfg = get_config(MOE).reduced()
    data = training.SyntheticLMData(cfg.vocab, seq_len=32, batch=8, seed=1)
    _, hist = training.train_loop(
        Model(cfg, device="cpu"), data, steps=40,
        opt_cfg=training.AdamWConfig(lr=1e-3, warmup_steps=10), log_every=5)
    assert hist[-1]["ce"] < hist[0]["ce"], hist
    assert all(np.isfinite(h["aux"]) for h in hist)


# -- the launcher ------------------------------------------------------------

def test_launcher_trains_on_the_cpu_and_writes_a_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "ck")
    assert train_launch.main([
        "--arch", MOE, "--reduced", "--device", "cpu", "--steps", "3",
        "--batch", "2", "--seq", "16", "--checkpoint", path]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["step"] for r in rows] == [0, 2]
    assert all(set(r) == {"ce", "aux", "loss", "step", "wall"} for r in rows)
    assert lines[-1] == f"saved checkpoint to {path}"
    assert training.checkpoint_step(path) == 3
    assert os.path.exists(os.path.join(path, "arrays.npz"))


def test_launcher_defaults_to_the_card():
    """Without ``--device`` the launcher asks for the card, and raises on
    a host that has none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", MOE, "--reduced", "--steps", "1"])

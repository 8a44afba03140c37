"""The port's mesh layout as a rank program, against the JAX reference on
the CPU.

- The rank program on in-process ranks (``ThreadMesh``) at (1, 4), (2, 2)
  and (2, 4), on the reduced phi3.5-MoE, qwen3-32b, phi4-mini, gemma-7b
  (tied embeddings), gemma3-27b (a sliding-window ring), qwen2-vl and
  DeepSeek-V3 with the weights carried from JAX: the logits of a prefill
  and 8 greedy decode steps within 1e-4 of the largest logit of the
  reference's unsharded ``Model`` (fp32), the greedy streams identical.
  The reduced configs have 4 heads, 2 kv heads and 4 experts, so (2, 4)
  splits ``wq`` and replicates ``wk``/``wv``, and (2, 2) puts the experts
  over (data, model).
- The plain ``decode_attn`` with its log-sum-exp, merged over 4 sequence
  shards (one of them empty), equals the unsharded result within 1e-5.
- Four gloo processes (``DistMesh``, 2 x 2) give the thread transport's
  logits within 1e-6.
- On a (2, 4) mesh, rank 0's ``meta`` trace (``launch.specs.
  lowering_args``) gives the FLOPs, temp, outputs and collective bytes of
  the thread transport's rank 0 on CPU tensors, exactly; its argument
  bytes equal the reckoning from the reference's ``jax.eval_shape`` leaves
  and ``PartitionSpec``s (each leaf's bytes over the product of the sizes
  of the axes on its dims), as do the dry run's per-device records on the
  16 x 16 and 2 x 16 x 16 meshes.
- The SSM, hybrid and encoder-decoder families refuse a ``model`` axis
  above 1 (ROADMAP A4); a mesh train record keeps its specs' arguments.
"""

import functools
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_mesh import B, CAP, PROMPT, assemble, gloo_mesh_run, \
    rank_body  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.distributed import ThreadMesh  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import (MeshLayout,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import make_pc  # noqa: E402

ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-32b", "phi4-mini-3.8b", "gemma-7b",
         "gemma3-27b", "qwen2-vl-7b", "deepseek-v3-671b")
MESHES = ((1, 4), (2, 2), (2, 4))
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reduced config's JAX params (seed 0) as numpy leaves, the prompt,
    and the unsharded JAX Model's prefill and greedy decode logits and
    stream."""
    cfg_j = jax_get_config(arch).reduced()
    mj = JaxModel(cfg_j)
    params = jax.tree.map(np.asarray, jax.jit(mj.init)(jax.random.PRNGKey(0)))
    pj = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(mj.prefill)
    decode = jax.jit(mj.decode_step)
    tokens = np.random.default_rng(7).integers(1, 500, (B, PROMPT))
    cache = mj.init_cache(B, CAP)
    logits, cache = prefill(pj, {"tokens": jnp.asarray(tokens)}, cache)
    out = [np.asarray(logits)]
    tok = jnp.argmax(logits[:, -1:, :cfg_j.vocab], -1)
    stream = [np.asarray(tok)]
    for _ in range(STEPS):
        logits, cache = decode(pj, tok, cache)
        out.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, :, :cfg_j.vocab], -1)
        stream.append(np.asarray(tok))
    return params, tokens, out, np.concatenate(stream, 1)


def _thread_run(arch, shape, kernels=False):
    cfg = get_config(arch).reduced()
    params, tokens, _, _ = _reference(arch)
    layout = MeshLayout(shape, ("data", "model"))
    res = ThreadMesh(layout).run(
        lambda rm: rank_body(cfg, params, tokens, STEPS, rm, kernels))
    logits = assemble(layout, cfg, [r[0] for r in res], B)
    stream = assemble(layout, cfg, [[r[1]] for r in res], B)[0]
    return logits, stream, res


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_program_matches_jax(arch, shape):
    _, _, want, want_stream = _reference(arch)
    got, stream, res = _thread_run(arch, shape, kernels=arch == ARCHS[0])
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
    np.testing.assert_array_equal(stream, want_stream)
    assert all(r[2] > 0 for r in res)            # every rank communicated


def test_decode_attn_lse_merges_over_sequence_shards():
    """Four shards of a 64-position cache, the last one past every row's
    fill level: merged by their log-sum-exps, the partial outputs equal
    the unsharded attention; an empty shard's LSE is -inf."""
    g = torch.Generator().manual_seed(0)
    b, h, hkv, d, s, n = 3, 8, 2, 32, 64, 4
    q = torch.randn(b, h, d, generator=g)
    k = torch.randn(b, s, hkv, d, generator=g)
    v = torch.randn(b, s, hkv, d, generator=g)
    valid = torch.tensor([5, 33, 48])
    want, want_lse = ref.decode_attn_ref(q, k, v, valid, return_lse=True)
    assert torch.equal(want, ref.decode_attn_ref(q, k, v, valid))
    scores = torch.einsum("bhd,bshd->bhs", q,
                          k.repeat_interleave(h // hkv, 2)) * d ** -0.5
    live = torch.arange(s)[None, None] < valid[:, None, None]
    torch.testing.assert_close(
        want_lse, torch.logsumexp(scores.masked_fill(~live, -torch.inf), -1))
    c = s // n
    outs, lses = [], []
    for i in range(n):
        lv = torch.clamp(valid - i * c, 0, c)
        o, lse = decode_attn(q, k[:, i * c:(i + 1) * c].contiguous(),
                             v[:, i * c:(i + 1) * c].contiguous(), lv,
                             return_lse=True)
        outs.append(o)
        lses.append(lse)
    assert torch.isinf(lses[-1]).all() and (lses[-1] < 0).all()
    lse_all = torch.stack(lses)
    w = torch.exp(lse_all - torch.logsumexp(lse_all, 0))
    merged = (torch.stack(outs) * w[..., None]).sum(0)
    torch.testing.assert_close(merged, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.logsumexp(lse_all, 0), want_lse,
                               rtol=0, atol=1e-5)


def test_gloo_ranks_match_the_thread_transport(tmp_path):
    arch = "phi3.5-moe-42b-a6.6b"
    cfg = get_config(arch).reduced()
    params, tokens, _, _ = _reference(arch)
    layout = MeshLayout((2, 2), ("data", "model"))
    steps = 2                    # process start and rendezvous dominate
    got = gloo_mesh_run(str(tmp_path), layout, cfg, params, tokens, steps)
    want = ThreadMesh(layout).run(
        lambda rm: rank_body(cfg, params, tokens, steps, rm))
    for (g_logits, g_stream, g_bytes), (w_logits, w_stream, w_bytes) in zip(
            got, want):
        for a, b in zip(g_logits, w_logits):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max())
        np.testing.assert_array_equal(g_stream, w_stream)
        assert g_bytes == w_bytes


# -- the dry run on meshes -----------------------------------------------------

def _stand_in(layout):
    return types.SimpleNamespace(axis_names=layout.axis_names,
                                 devices=np.empty(layout.dims))


def _reckon(specs_tree, shapes_tree, layout) -> int:
    """Per-device bytes from the reference's specs: each leaf's bytes over
    the product of the sizes of the axes on its dims."""
    total = 0
    for spec, leaf in zip(
            jax.tree.leaves(specs_tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)),
            jax.tree.leaves(shapes_tree)):
        n = 1
        for entry in spec:
            if entry is not None:
                n *= layout.axis_size(entry)
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


def _reference_args_bytes(arch, shape, layout, reduced=False) -> int:
    cfg_j = jax_get_config(arch)
    cfg_j = cfg_j.reduced() if reduced else cfg_j
    mesh = _stand_in(layout)
    b, s = shape.global_batch, shape.seq_len
    params = jax.eval_shape(lambda: jrules.tf.init_params(
        jax.random.PRNGKey(0), cfg_j))
    total = _reckon(jrules.param_specs(cfg_j, mesh), params, layout)
    cache = jax.eval_shape(lambda: jrules.tf.init_cache(cfg_j, b, s))
    total += _reckon(jrules.cache_specs(cfg_j, mesh, b, s), cache, layout)
    tok_len = 1 if shape.kind == "decode" else s
    tok = jax.ShapeDtypeStruct((b, tok_len), jnp.int32)
    return total + _reckon([jrules.input_sharding(cfg_j, mesh, b)], [tok],
                           layout)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"])
def test_meta_trace_equals_the_thread_rank_0(arch):
    cfg = get_config(arch).reduced()
    layout = MeshLayout((2, 4), ("data", "model"))
    params_np, _, _, _ = _reference(arch)
    for shape in (InputShape("t_prefill", 16, 2, "prefill"),
                  InputShape("t_decode", 32, 2, "decode")):
        step, args, rm = specs.lowering_args(cfg, shape, layout)
        want = dryrun.trace_step(step, args)
        want_coll = rm.collective_bytes
        assert dryrun.tree_bytes(args) == _reference_args_bytes(
            arch, shape, layout, reduced=True)
        assert want_coll > 0

        def body(rm, shape=shape):
            from repro_torch.bridge import (shard_cache, shard_params,
                                            shard_tensor, to_torch)
            from repro_torch.sharding import (cache_specs, input_sharding,
                                              param_specs)
            b, s = shape.global_batch, shape.seq_len
            model = Model(cfg, device="cpu",
                          pc=make_pc(cfg, rm, batch=b, cap=s))
            params = shard_params(to_torch(params_np),
                                  param_specs(cfg, rm), rm, rm.rank)
            cache = model.init_cache(b, s)
            assert dryrun.tree_bytes(cache) == dryrun.tree_bytes(
                shard_cache(specs.abstract_cache(cfg, b, s),
                            cache_specs(cfg, rm, b, s), rm, rm.rank))
            n = s if shape.kind == "prefill" else 1
            toks = shard_tensor(torch.ones((b, n), dtype=torch.int32),
                                input_sharding(cfg, rm, b), rm, rm.rank)
            if shape.kind == "prefill":
                fn, a = model.prefill, (params, {"tokens": toks}, cache)
            else:
                fn, a = model.decode_step, (params, toks, cache)
            if rm.rank != 0:
                fn(*a)
                return None
            return dryrun.trace_step(fn, a), rm.collective_bytes

        got, coll = ThreadMesh(layout).run(body)[0]
        assert (got["flops"], got["temp_bytes"], got["output_bytes"],
                coll) == (want["flops"], want["temp_bytes"],
                          want["output_bytes"], want_coll), shape.name


def test_dryrun_mesh_records(tmp_path, capsys):
    """``--both-meshes`` on phi3.5's decode_32k: per-device records named
    as the reference's, arguments equal to the reckoning from JAX's specs
    to the byte, and the figures each record traced and reckoned."""
    arch = "phi3.5-moe-42b-a6.6b"
    rc = dryrun.main(["--arch", arch, "--shape", "decode_32k",
                      "--both-meshes", "--out", str(tmp_path)])
    assert rc == 0
    assert capsys.readouterr().out.count(": ok") == 2
    for name, mp in (("pod16x16", False), ("pod2x16x16", True)):
        rec = json.loads((tmp_path / f"{arch}_decode_32k_{name}.json")
                         .read_text())
        layout = make_production_mesh(multi_pod=mp)
        assert rec["mesh"] == name and rec["n_devices"] == layout.size
        assert rec["memory"]["argument_size_in_bytes"] == \
            _reference_args_bytes(arch, SHAPES["decode_32k"], layout)
        assert "cost.collective_bytes" in rec["figures"]["traced"]
        assert rec["cost"]["collective_bytes"] > 0
        assert rec["memory"]["per_device_total_gib"] < 10


def test_train_and_deferred_pairs_keep_exact_arguments():
    """A train pair on a mesh has no rank program (ROADMAP A5): exact
    arguments from the shards (params and AdamW moments), FLOPs and temp
    from the one-card trace, said so in ``figures``. mamba2 builds no rank
    program once ``model`` splits (ROADMAP A4)."""
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    shape = InputShape("t_train", 16, 4, "train")
    rec, = dryrun.run_mesh_pair(cfg, shape, (False,))
    step, args, _ = specs.lowering_args(
        cfg, shape, MeshLayout((16, 16), ("data", "model")))
    assert step is None
    assert rec["memory"]["argument_size_in_bytes"] == dryrun.tree_bytes(args)
    assert rec["cost"]["collective_bytes"] is None
    assert "cost.flops" in rec["figures"]["reckoned"]
    assert "ROADMAP A5" in rec["figures"]["note"]
    one_card = dryrun.trace_step(*specs.step_args(cfg, shape))
    assert rec["cost"]["flops"] == one_card["flops"]
    layout = MeshLayout((1, 4), ("data", "model"))
    for arch in ("mamba2-1.3b", "zamba2-7b", "seamless-m4t-large-v2"):
        cfg = get_config(arch).reduced()

        def build(rm, cfg=cfg):
            with pytest.raises(ValueError, match="ROADMAP A4"):
                Model(cfg, device="cpu", pc=make_pc(cfg, rm, batch=4,
                                                    cap=16))
        ThreadMesh(layout).run(build)
        step, _, _ = specs.lowering_args(
            cfg, InputShape("t_decode", 16, 4, "decode"), layout)
        assert step is None

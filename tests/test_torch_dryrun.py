"""The port's dry run against the JAX reference, on the CPU.

- ``supported`` and ``opt_config_for`` equal the reference's for all 40
  (arch x shape) pairs;
- at full width, every abstract leaf of the params, the AdamW state (under
  ``opt_config_for``), the cache and the step inputs of every supported
  pair has the shape and dtype of ``jax.eval_shape`` of the reference's
  ``init_params``, ``adamw_init`` and ``init_cache``, and of its
  ``input_specs`` on a 1 x 1 mesh with the shardings dropped, in the same
  tree;
- ``param_specs(cfg, n)`` splits exactly the expert leaves that the
  reference's ``param_specs`` puts on its EP axes, at the same dim, for n
  of 1, 4 and 8 (a stand-in mesh of shape (1, n): the reference reads only
  its axis names and device grid);
- on the reduced configs, the ``meta`` trace's FLOPs, high-water mark and
  output bytes equal the same tracker's over the same step run on real CPU
  tensors, for train, prefill and decode;
- ``run_pair``'s and ``run_one``'s records (per-card arguments reckoned under the EP layout,
  round bytes, skips) and the CLI (exit 0 and a JSON record; a pair that
  fails to trace is ``FAILED`` and exits 1).
"""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.bridge import map_tree, tree_leaves  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, InputShape  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import moe_layer_count  # noqa: E402
from repro_torch.roofline import ep_round_bytes  # noqa: E402
from repro_torch.sharding import param_specs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: several test workers on one host make every
    multi-threaded op wait for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sds(t):
    return jax.ShapeDtypeStruct(tuple(t.shape),
                                jnp.dtype(str(t.dtype).split(".")[-1]))


def _assert_like(port_tree, ref_tree):
    """Same tree (dict keys, tuple arity) and, leaf by leaf, the same shape
    and dtype."""
    ref_leaves, ref_def = jax.tree.flatten(ref_tree)
    got_leaves, got_def = jax.tree.flatten(map_tree(_sds, port_tree))
    assert got_def == ref_def
    assert ([(a.shape, a.dtype) for a in got_leaves]
            == [(b.shape, b.dtype) for b in ref_leaves])


def test_supported_and_opt_config_equal_the_reference_for_40_pairs():
    pairs = 0
    for arch in ARCH_IDS:
        cfg, ref = get_config(arch), jconfigs.get_config(arch)
        assert (dataclasses.asdict(specs.opt_config_for(cfg))
                == dataclasses.asdict(jspecs.opt_config_for(ref)))
        for name in SHAPES:
            assert (specs.supported(cfg, SHAPES[name])
                    == jspecs.supported(ref, jconfigs.SHAPES[name]))
            pairs += 1
    assert pairs == 40
    assert specs.opt_config_for(
        get_config("deepseek-v3-671b")).state_dtype == "bfloat16"
    assert (specs.SRC_LEN, specs.AUDIO_TGT_FRac, specs.BIG_MODEL_PARAMS) == (
        jspecs.SRC_LEN, jspecs.AUDIO_TGT_FRac, jspecs.BIG_MODEL_PARAMS)


@pytest.fixture(scope="module")
def mesh11():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_leaves_equal_jax_eval_shape(arch, mesh11):
    cfg, ref = get_config(arch), jconfigs.get_config(arch)
    ref_params = jax.eval_shape(
        lambda: jtf.init_params(jax.random.PRNGKey(0), ref))
    params = specs.abstract_params(cfg)
    assert all(t.is_meta for t in tree_leaves(params))
    _assert_like(params, ref_params)

    opt, opt_cfg = specs.abstract_opt(cfg, params)
    ref_cfg = jspecs.opt_config_for(ref)
    ref_opt = jax.eval_shape(lambda: joptim.adamw_init(
        jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), ref_params),
        ref_cfg))
    _assert_like(opt, ref_opt)

    for name, shape in SHAPES.items():
        if not specs.supported(cfg, shape):
            continue
        rshape = jconfigs.SHAPES[name]
        ref_in = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
            jspecs.input_specs(ref, rshape, mesh11))
        _assert_like(specs.input_specs(cfg, shape), ref_in)
        if shape.kind == "train":
            continue
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "prefill":
            cap = s // specs.AUDIO_TGT_FRac if cfg.is_encoder_decoder else s
            src = s if cfg.is_encoder_decoder else 0
        else:
            cap, src = s, specs.SRC_LEN if cfg.is_encoder_decoder else 0
        ref_cache = jax.eval_shape(
            lambda: jtf.init_cache(ref, b, cap, src_len=src))
        _assert_like(specs.abstract_cache(cfg, b, cap, src_len=src),
                     ref_cache)
        # step_args hands the step exactly these leaves.
        fn, args = specs.step_args(cfg, shape)
        _assert_like(args[2], ref_cache)


def _jax_expert_dims(spec_tree, ep_axes):
    """Per leaf (JAX flatten order): the dim the reference puts the EP axes
    at, or None."""
    out = []
    for leaf in jax.tree.leaves(spec_tree,
                                is_leaf=lambda x: isinstance(x, P)):
        dims = [i - len(leaf) for i, ax in enumerate(leaf)
                if ep_axes is not None and ax == ep_axes]
        out.append(dims[0] if dims else None)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_split_the_reference_expert_leaves(arch):
    for reduced in (False, True):
        cfg, ref = get_config(arch), jconfigs.get_config(arch)
        if reduced:
            cfg, ref = cfg.reduced(), ref.reduced()
        for n in (1, 4, 8):
            mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                         devices=np.empty((1, n)))
            want = _jax_expert_dims(jrules.param_specs(ref, mesh),
                                    jrules.ep_axes_for(ref, mesh))
            got = tree_leaves(param_specs(cfg, n))
            assert got == want, (arch, reduced, n)
            assert len(got) == len(tree_leaves(specs.abstract_params(cfg)))


TINY = (InputShape("train_tiny", 16, 2, "train"),
        InputShape("prefill_tiny", 16, 2, "prefill"),
        InputShape("decode_tiny", 16, 2, "decode"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_trace_equals_the_cpu_run(arch):
    """The step traced on ``meta`` and the same step run on CPU tensors
    (zeros of the abstract leaves) give the same FLOPs, high-water mark
    above the arguments and output bytes, exactly."""
    cfg = get_config(arch).reduced()
    _, train, prefill, serve = specs.make_step_fns(cfg, device="cpu")
    steps = {"train": train, "prefill": prefill, "decode": serve}
    for shape in TINY:
        fn, args = specs.step_args(cfg, shape)
        meta = dryrun.trace_step(fn, args)
        cpu_args = map_tree(lambda t: torch.zeros_like(t, device="cpu"),
                            args)
        cpu = dryrun.trace_step(steps[shape.kind], cpu_args)
        for key in ("flops", "temp_bytes", "output_bytes"):
            assert meta[key] == cpu[key], (shape.kind, key, meta, cpu)
        assert meta["flops"] > 0 and meta["temp_bytes"] > 0
        assert (dryrun.argument_bytes(cfg, shape, args)
                == dryrun.tree_bytes(cpu_args))


def test_storage_tracker_counts_storages_not_tensors():
    x = torch.empty((256, 256), device="meta")
    with dryrun.StorageTracker([x]) as tr:
        y = x * 2                       # 256 KiB
        v = y.view(-1)[:10]             # a view: nothing
        x.add_(1)                       # in place on an argument: nothing
        assert tr.live == tr.peak == 256 * 256 * 4
        z = y + 1
        del y, z
        assert tr.live == 256 * 256 * 4 and tr.peak == 2 * 256 * 256 * 4
        del v
        assert tr.live == 0


def test_run_one_records_and_the_ep_layout():
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    shape = InputShape("decode_tiny", 16, 6, "decode")
    one, four = dryrun.run_pair(cfg, shape, (1, 4))
    assert one["status"] == four["status"] == "ok"
    assert one["device"] == "meta" and four["n_devices"] == 4
    _, args = specs.step_args(cfg, shape)
    experts = sum(t.untyped_storage().nbytes()
                  for t, s in zip(tree_leaves(args[0]),
                                  tree_leaves(param_specs(cfg, 4)))
                  if s is not None)
    assert experts > 0
    assert (one["memory"]["argument_size_in_bytes"]
            - four["memory"]["argument_size_in_bytes"]) == experts * 3 // 4
    assert one["cost"]["collective_bytes"] == 0
    assert four["cost"]["collective_bytes"] == (
        moe_layer_count(cfg) * ep_round_bytes(cfg, 6, 4) // 4)
    assert four["cost"]["flops"] == one["cost"]["flops"]
    # One trace for every card count: run_one's record is run_pair's.
    alone = dryrun.run_one(cfg, shape, n_cards=4)
    for key in ("memory", "cost", "roofline"):
        assert alone[key] == four[key], key
    assert "cost.collective_bytes" in four["figures"]["reckoned"]
    assert set(four["roofline"]) >= {"compute_s", "memory_s",
                                     "collective_s", "dominant",
                                     "memory_floor_s", "model_flops"}
    # A train step's moments lie like the params: 3 x the expert share.
    tshape = InputShape("train_tiny", 16, 2, "train")
    t1 = dryrun.run_one(cfg, tshape)["memory"]["argument_size_in_bytes"]
    t4 = dryrun.run_one(cfg, tshape, 4)["memory"]["argument_size_in_bytes"]
    assert t1 - t4 == 3 * experts * 3 // 4         # fp32 params, m, v
    skipped = dryrun.run_pair("qwen3-32b", "long_500k", (1, 8))
    assert [r["cards"] for r in skipped] == [1, 8]
    assert all(r["status"].startswith("skipped") for r in skipped)


def test_cli_writes_records_and_fails_loudly(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry"
    rc = dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                      "--cards", "1", "4", "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "device meta" in text and text.count(": ok") == 2
    rec = json.loads((out / "mamba2-1.3b_decode_32k_4cards.json").read_text())
    assert rec["status"] == "ok" and rec["cards"] == 4
    assert rec["cost"]["collective_bytes"] == 0          # no experts

    def boom(cfg, shape):
        raise RuntimeError("cannot trace")
    monkeypatch.setattr(specs, "step_args", boom)
    rc = dryrun.main(["--arch", "gemma-7b", "--shape", "decode_32k",
                      "--out", str(out)])
    assert rc == 1
    assert "gemma-7b x decode_32k x 1 card(s): FAILED" in (
        capsys.readouterr().out)

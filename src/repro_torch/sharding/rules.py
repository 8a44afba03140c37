"""Sharding rules for every architecture on a mesh (port of
``repro/sharding/rules.py``).

Mesh axes: ``(data, model)``, or ``(pod, data, model)`` multi-pod
(``launch.mesh``). The policy is the reference's:

- vocab (embedding, lm-head) over ``model``;
- attention heads over ``model`` iff the head count divides the axis
  (q and o by the query heads, k and v by the kv heads, leaf by leaf);
- FFN d_ff over ``model`` (the column -> row parallel pair), MLA's
  ``wq_a`` over its latent rank, mamba's ``in_proj``/``out_proj``/conv;
- MoE experts over the flat EP axes (``("data", "model")`` when E
  divides data x model, else ``("model",)``; ``pod`` never joins EP);
- batch over ``(pod, data)``; KV caches: batch over ``data`` (+ ``pod``),
  sequence over ``model`` (``long_500k``, batch 1: over ``(data,
  model)``); SSM state: batch over data, heads over model.

A spec is a plain tuple, one entry per dim of its leaf: None
(replicated), an axis name, or a tuple of several names (the entries of
the reference's ``PartitionSpec``, which writes a one-name tuple as the
name). ``input_sharding`` mirrors the reference's ``P`` as it is:
entries for the leading dims only. A mesh is anything with
``axis_names`` and ``devices.shape`` (``launch.mesh.MeshLayout``, a
bound ``distributed.mesh.RankMesh``). Every rule is
decided against the shapes of ``init_params`` / ``init_cache`` on
``meta``, so a dim is split only where its axis divides it.

The EP engines' layout (``serving.distributed``) stays: ``param_specs(cfg,
n)`` with a rank count, ``ep_size_for`` and ``make_pc(cfg, group)``.
"""

from __future__ import annotations

from ..models.layers import ParallelContext


def _axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def _size(mesh, axes) -> int:
    n = 1
    for ax in ((axes,) if isinstance(axes, str) else axes):
        n *= _axis_size(mesh, ax)
    return n


def _is_mesh(x) -> bool:
    return hasattr(x, "axis_names")


def _entry(axes):
    """A spec entry over ``axes``: one name as the name, several as a
    tuple (as ``PartitionSpec`` normalises its entries)."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _divides(n: int, k: int) -> bool:
    return n > 0 and k > 0 and n % k == 0


# ---------------------------------------------------------------------------
# Expert parallelism over a rank count (the EP engines)
# ---------------------------------------------------------------------------

def ep_size_for(cfg, group) -> int | None:
    """The EP rank count the experts of ``cfg`` shard over on ``group``
    (the counterpart of ``ep_axes_for``), or None when the config has no
    MoE layers or its expert count does not divide the group. ``group``
    may also be a rank count."""
    if cfg.moe is None or group is None:
        return None
    n = group if isinstance(group, int) else group.n
    return n if cfg.moe.n_experts % n == 0 else None


def _walk(tree, leaf, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, leaf, path) for v in tree)
    return leaf(path, tree)


def _ep_only_specs(cfg, n: int):
    """A tree shaped like ``init_params(cfg)`` whose leaves say how each
    param leaf lies over ``n`` EP ranks: -3 (the expert axis of a stacked
    (count, E, d, f) expert leaf, split in blocks of E/n) when the experts
    shard (``ep_size_for``), else None (replicated on every rank)."""
    from ..models.transformer import init_params
    split = -3 if ep_size_for(cfg, n) is not None else None
    return _walk(init_params(cfg, device="meta"),
                 lambda path, _: split if "experts" in path else None)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def ep_axes_for(cfg, mesh) -> tuple[str, ...] | None:
    """Flat expert-parallel axes of a MoE config on this mesh."""
    if cfg.moe is None:
        return None
    e = cfg.moe.n_experts
    if e % (_axis_size(mesh, "data") * _axis_size(mesh, "model")) == 0:
        return ("data", "model")
    if e % _axis_size(mesh, "model") == 0:
        return ("model",)
    return None


def _leaf_spec(path, shape, mesh, ep) -> tuple:
    """The rule table, keyed on the trailing dict key of the leaf's path."""
    name = path[-1] if path else ""
    m = _axis_size(mesh, "model")
    nd = len(shape)

    def at(pos: int, ax, size: int) -> tuple:
        out = [None] * nd
        if _divides(shape[pos], size):
            out[pos] = ax
        return tuple(out)

    if "experts" in path:                     # (count, E, d, f)
        return (at(-3, _entry(ep), _size(mesh, ep)) if ep is not None
                else (None,) * nd)
    rules = {"embed": 0, "lm_head": 1,
             "wq": -2, "wk": -2, "wv": -2,     # (..., d, H, hd)
             "wo": -3,                         # (..., H, hd, d)
             "wq_b": -2, "wk_b": -2, "wv_b": -2,   # (..., r, H, dh)
             "wq_a": -1,                       # (..., d, r)
             "w_gate": -1, "w_up": -1,         # (..., d, f)
             "w_down": -2,                     # (..., f, d)
             "in_proj": -1, "out_proj": -2,    # mamba
             "conv_w": -1, "conv_b": -1}
    if name in rules:
        return at(rules[name], "model", m)
    return (None,) * nd     # norms, router, biases, frontend_proj, A_log, D


def param_specs(cfg, mesh):
    """The spec tree matching ``init_params(cfg)``. ``mesh`` a mesh: the
    reference's rule table. ``mesh`` an int n: the EP engines' layout over n
    ranks (each leaf -3 or None)."""
    if not _is_mesh(mesh):
        return _ep_only_specs(cfg, mesh)
    from ..models.transformer import init_params
    ep = ep_axes_for(cfg, mesh)
    return _walk(init_params(cfg, device="meta"),
                 lambda path, t: _leaf_spec(path, tuple(t.shape), mesh, ep))


# ---------------------------------------------------------------------------
# Caches and inputs
# ---------------------------------------------------------------------------

def _batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_axes_for(mesh, batch: int) -> tuple[str, ...] | None:
    """The axes a batch of ``batch`` rows shards over (``input_sharding``
    and ``cache_specs`` alike): ``(pod, data)``, else ``("data",)``, else
    None (replicated)."""
    dp = _batch_axes(mesh)
    if _divides(batch, _size(mesh, dp)):
        return dp
    if _divides(batch, _axis_size(mesh, "data")):
        return ("data",)
    return None


def seq_axes_for(mesh, batch: int):
    """The axis entry a cache's sequence shards over: "model", or
    ``("data", "model")`` for one unsharded row (``long_500k``)."""
    if batch_axes_for(mesh, batch) is None and batch == 1:
        return ("data", "model")
    return "model"


def cache_specs(cfg, mesh, batch: int, cap: int, src_len: int = 0):
    """The spec tree matching ``init_cache(cfg, batch, cap, src_len)``."""
    from ..models.transformer import init_cache
    nb = _size(mesh, _batch_axes(mesh))
    m = _axis_size(mesh, "model")
    batch_ax = batch_axes_for(mesh, batch)
    seq_ax = seq_axes_for(mesh, batch)
    n_seq = m if seq_ax == "model" else nb * m

    def leaf(path, t):
        name = path[-1] if path else ""
        out = [None] * t.ndim
        if name == "len":
            return tuple(out)
        if name in ("k", "v", "xk", "xv", "ckv", "k_rope", "conv", "state"):
            if batch_ax is not None:                 # (count, B, ...)
                out[1] = _entry(batch_ax)
        if name in ("k", "v", "xk", "xv", "ckv", "k_rope"):
            if _divides(t.shape[2], n_seq):          # (count, B, S, ...)
                out[2] = seq_ax
        elif name == "conv" and _divides(t.shape[-1], m):
            out[-1] = "model"                        # (count, B, K-1, cdim)
        elif name == "state" and _divides(t.shape[2], m):
            out[2] = "model"                         # (count, B, H, hd, N)
        return tuple(out)

    return _walk(init_cache(cfg, batch, cap, src_len=src_len, device="meta"),
                 leaf)


def input_sharding(cfg, mesh, batch: int) -> tuple:
    """Spec of token / frame / embed inputs: the batch over (pod, data),
    as the reference's ``P`` (one entry, or none when replicated)."""
    ax = batch_axes_for(mesh, batch)
    return (_entry(ax),) if ax is not None else ()


def make_pc(cfg, mesh, moe_impl: str = "ep", aurora_rounds=None, *,
            batch: int | None = None, cap: int | None = None
            ) -> ParallelContext:
    """ParallelContext for this (config, mesh).

    ``mesh`` a bound mesh (``distributed.mesh.RankMesh``): the rank
    program's layout for a batch of ``batch`` rows and a cache of ``cap``
    positions (both global): batch axes and cache sequence axes as
    ``input_sharding`` and ``cache_specs`` give them, tensor parallelism
    over ``model``, and the experts over ``ep_axes_for``'s axes through
    the mesh's EP group ("ep" or "aurora"; dense dispatch when the experts
    do not shard, as in the reference).

    ``mesh`` an ``EPGroup`` or a rank count: the EP engines' layout. Falls
    back to dense dispatch, silently as the reference does, when the
    experts do not shard over the group (``serving.distributed.distribute``
    refuses that case loudly)."""
    if not _is_mesh(mesh):
        impl = moe_impl if ep_size_for(cfg, mesh) is not None else "dense"
        return ParallelContext(group=mesh, moe_impl=impl,
                               aurora_rounds=aurora_rounds)
    if batch is None or cap is None:
        raise ValueError("a mesh ParallelContext needs the global batch and "
                         "cache capacity (batch=, cap=)")
    ep = ep_axes_for(cfg, mesh)
    impl = moe_impl if ep is not None else "dense"
    group = mesh.ep_group(ep) if ep is not None else None
    batch_ax = batch_axes_for(mesh, batch)
    seq = seq_axes_for(mesh, batch)
    return ParallelContext(
        group=group, moe_impl=impl, aurora_rounds=aurora_rounds, mesh=mesh,
        data_axes=batch_ax or (), model_axis="model",
        seq_axis=(seq,) if isinstance(seq, str) else seq, ep_axes=ep,
        batch=batch, cap=cap)

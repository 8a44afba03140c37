"""Abstract inputs and state of the dry run, and its step functions (port
of ``repro/launch/specs.py``): tensors on the ``meta`` device, which carry
a shape and a dtype and allocate nothing.

Per input shape (``configs.shapes``):
  train        -> train_step(params, opt, batch)
  prefill      -> prefill_step(params, inputs, cache)
  decode       -> serve_step(params, token, cache)   (ONE token, full cache)

Family conventions, as in the reference: a VLM's prefill takes patch
embeddings; an encoder-decoder's train and prefill take source frames and
a target prefix of ``seq_len // 4``, and its decode carries a
``SRC_LEN``-frame cross-attention context. ``long_500k`` is traced only
for sub-quadratic configs (``supported``).

The reference attaches a mesh sharding to every leaf; the port's leaves
have none (its EP layout over n cards is ``sharding.param_specs``, applied
by ``launch.dryrun``). Every function takes a ``ModelConfig`` and an
``InputShape``, so a caller can pass a depth-cut config and a shape of its
own, such as ``InputShape("serve_8x512", 512, 8, "decode")``.
"""

from __future__ import annotations

import torch

from ..models import Model, transformer as tf
from ..training.loop import make_train_step
from ..training.optim import AdamWConfig, adamw_init

SRC_LEN = 4_096          # enc-dec cross-attention context at decode
AUDIO_TGT_FRac = 4       # enc-dec: target prefix = seq_len // 4

# >100B-param configs keep AdamW moments in bf16 so optimizer state fits
# (the reference's rule, kept as it is).
BIG_MODEL_PARAMS = 100e9

META = torch.device("meta")


def supported(cfg, shape) -> bool:
    """Shape-skip matrix: long_500k only for sub-quadratic configs."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def opt_config_for(cfg) -> AdamWConfig:
    big = cfg.param_count() > BIG_MODEL_PARAMS
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def abstract_params(cfg):
    return tf.init_params(cfg, device=META)


def abstract_opt(cfg, params):
    """(AdamW state of ``params``, the ``AdamWConfig`` it is made for)."""
    opt_cfg = opt_config_for(cfg)
    return adamw_init(params, opt_cfg), opt_cfg


def abstract_cache(cfg, batch: int, cap: int, src_len: int = 0):
    return tf.init_cache(cfg, batch, cap, src_len=src_len, device=META)


def input_specs(cfg, shape) -> dict:
    """Abstract step inputs for one (arch x input shape)."""
    b, s = shape.global_batch, shape.seq_len

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device=META)

    def emb():
        return torch.empty((b, s, cfg.frontend_dim), dtype=torch.bfloat16,
                           device=META)

    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            return {"frames": emb(), "tokens": tok((b, s // AUDIO_TGT_FRac))}
        if shape.kind == "prefill" and cfg.input_mode == "patches":
            return {"embeds": emb()}
        return {"tokens": tok((b, s))}
    return {"tokens": tok((b, 1))}                      # decode


def make_step_fns(cfg, device=META):
    """(model, train_step, prefill_step, serve_step) of a plain-path
    ``Model(cfg, device)``: no kernels and no EP group, as the reference
    lowers its dry run with no kernels."""
    model = Model(cfg, device=device)
    train_step = make_train_step(model, opt_config_for(cfg))

    def prefill_step(params, inputs, cache):
        return model.prefill(params, inputs, cache)

    def serve_step(params, token, cache):
        return model.decode_step(params, token, cache)

    return model, train_step, prefill_step, serve_step


def step_args(cfg, shape):
    """(step_fn, abstract_args) of one (arch x input shape) on ``meta``
    (the reference's ``lowering_args``)."""
    _, train_step, prefill_step, serve_step = make_step_fns(cfg)
    params = abstract_params(cfg)
    inputs = input_specs(cfg, shape)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt, _ = abstract_opt(cfg, params)
        return train_step, (params, opt, inputs)
    if shape.kind == "prefill":
        tgt = (s // AUDIO_TGT_FRac) if cfg.is_encoder_decoder else s
        cache = abstract_cache(cfg, b, tgt,
                               src_len=s if cfg.is_encoder_decoder else 0)
        return prefill_step, (params, inputs, cache)
    cache = abstract_cache(cfg, b, s,
                           src_len=SRC_LEN if cfg.is_encoder_decoder else 0)
    return serve_step, (params, inputs["tokens"], cache)


# ---------------------------------------------------------------------------
# The mesh layout: rank 0's step on meta (the reference's lowering on its
# production meshes)
# ---------------------------------------------------------------------------

def rank_program_runs(cfg, shape, mesh) -> bool:
    """Whether rank 0's step of this pair is traced on the mesh: serving
    steps only (sharded training is ROADMAP A5), and not for the SSM,
    hybrid and encoder-decoder families once ``model`` splits (their rank
    program is ROADMAP A4)."""
    deferred = cfg.family in ("ssm", "hybrid") or cfg.is_encoder_decoder
    return shape.kind != "train" and not (
        deferred and mesh.shape["model"] > 1)


def _shard_inputs(cfg, inputs, mesh, rank: int, batch: int) -> dict:
    from ..bridge import shard_tensor
    from ..sharding import input_sharding
    spec = input_sharding(cfg, mesh, batch)
    return {k: shard_tensor(v, spec, mesh, rank) for k, v in inputs.items()}


def lowering_args(cfg, shape, mesh):
    """(step_fn, args, rank_mesh) of rank 0 on ``mesh`` (a
    ``launch.mesh.MeshLayout``): its shards of the params, of the AdamW
    moments at train (they lie like the params), of the cache and of the
    inputs, on ``meta`` (the reference's ``lowering_args`` on a mesh).
    ``step_fn`` runs the rank program over a ``CountingMesh``
    (``rank_mesh``), which counts its collective bytes; it is None where
    ``rank_program_runs`` is false (the arguments are still this rank's).
    Rank 0 stands for every rank: the rules split a dim only where its
    axes divide it, so every rank holds the same shapes."""
    from ..bridge import shard_cache, shard_params
    from ..distributed.mesh import CountingMesh
    from ..sharding import cache_specs, make_pc, param_specs
    b, s = shape.global_batch, shape.seq_len
    rank = 0
    pspecs = param_specs(cfg, mesh)
    params = shard_params(abstract_params(cfg), pspecs, mesh, rank)
    inputs = _shard_inputs(cfg, input_specs(cfg, shape), mesh, rank, b)
    rm = CountingMesh(mesh, rank)
    if shape.kind == "train":
        opt, _ = abstract_opt(cfg, abstract_params(cfg))
        opt = {"m": shard_params(opt["m"], pspecs, mesh, rank),
               "v": shard_params(opt["v"], pspecs, mesh, rank),
               "step": opt["step"]}
        return None, (params, opt, inputs), rm
    cap = (s // AUDIO_TGT_FRac if cfg.is_encoder_decoder else s) \
        if shape.kind == "prefill" else s
    src = ((s if shape.kind == "prefill" else SRC_LEN)
           if cfg.is_encoder_decoder else 0)
    cache = shard_cache(abstract_cache(cfg, b, cap, src_len=src),
                        cache_specs(cfg, mesh, b, cap, src), mesh, rank)
    if not rank_program_runs(cfg, shape, mesh):
        step = None
    else:
        model = Model(cfg, device=META, pc=make_pc(cfg, rm, batch=b,
                                                   cap=cap))
        if shape.kind == "prefill":
            def step(params, inputs, cache):
                return model.prefill(params, inputs, cache)
        else:
            def step(params, token, cache):
                return model.decode_step(params, token, cache)
    if shape.kind == "prefill":
        return step, (params, inputs, cache), rm
    return step, (params, inputs["tokens"], cache), rm

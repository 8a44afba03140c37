"""Dry run on the ``meta`` device (port of ``repro/launch/dryrun.py``).

Traces the step of every supported (architecture x input shape) pair on
abstract tensors (``launch.specs``) and records, per card of an EP layout
over ``--cards`` cards:

- memory: the step's arguments (params with the AdamW state at train, the
  cache and inputs at serving), its outputs, and its high-water mark above
  the arguments (``StorageTracker``);
- cost: FLOPs (``torch.utils.flop_counter.FlopCounterMode``), the bytes of
  the arguments touched once, and the EP rounds' bytes
  (``roofline.ep_round_bytes``);
- the roofline terms on the H100's data-sheet constants
  (``roofline.roofline_report``).

This entry point is the port's one deliberate exception to running on
the card: it allocates on ``meta`` by design (the reference lowers and
compiles, and runs nothing), prints ``meta`` as its device and never
touches CUDA. The step is traced once, at one card; for ``--cards`` n > 1
the per-card arguments are reckoned from ``sharding.param_specs`` (expert
leaves in blocks of E/n, everything else replicated, as the port's EP
engines hold them) and the collective bytes from ``ep_round_bytes``. Each
record says which of its figures are traced and which are reckoned.

With ``--multi-pod`` or ``--both-meshes`` it records, per device of the
reference's production meshes (``pod16x16``: (16, 16) over (data,
model), 256 devices; ``pod2x16x16``: (2, 16, 16) over (pod, data, model),
512), the mesh layout of ``sharding.rules``: rank 0's step as the rank
program (``launch.specs.lowering_args``) over a ``CountingMesh`` on
``meta``. Its arguments are rank 0's shards, exact; FLOPs, temp, outputs
and collective bytes (each collective's result, the convention of the
reference's ``collective_bytes_from_hlo``) are traced from the rank
program. The row-parallel partial sums travel in fp32
(``models.layers.row_parallel``), where the reference's lowering sums
them in the activation dtype, so their all-reduces count twice its
bytes. Rank 0 stands for every device: the rules split a dim only where
its axes divide it, so every rank holds the same shapes. Train steps (no
rank-program backward: ROADMAP A5) and the serving steps of the SSM,
hybrid and encoder-decoder families (their rank program is ROADMAP A4)
keep exact arguments from the shards and take FLOPs, temp and outputs
from the one-card trace as upper bounds, with no collective bytes. Each
record says which of its figures are traced and which are reckoned.

A pair that cannot be traced is reported ``FAILED`` with its traceback,
and the run exits 1; nothing is replaced by an analytic guess.

Two of the reference's flags have no counterpart:
``--no-calibrate`` skips the correction for XLA counting a ``scan`` body
once, which the port does not need: its layers run in a Python loop, so
the trace sees every layer; and ``--moe-impl`` picks the reference's
lowering, while here the step is traced once on the plain path and both
EP forms (the monolithic all-to-all and Aurora's rounds) move the same
bytes (``roofline.ep_round_bytes``), so no figure would depend on it.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --shape train_4k
  python -m repro_torch.launch.dryrun --all --cards 1 4 8 [--out DIR]
  python -m repro_torch.launch.dryrun --arch phi3.5-moe-42b-a6.6b \
      --shape decode_32k --both-meshes
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from ..bridge import tree_leaves

DEFAULT_OUT = "experiments/dryrun_torch"


class StorageTracker(TorchDispatchMode):
    """Live bytes of the storages made while the mode is on, and their
    peak. Each op's outputs are looked at: a storage not seen before adds
    its ``nbytes()``, and subtracts it when it is freed
    (``weakref.finalize`` on the storage). Views share their base's
    storage and in-place ops return their input's, so neither adds
    anything. The storages of ``held`` (the step's arguments) are known
    from the start and never counted."""

    def __init__(self, held=()):
        super().__init__()
        self.seen = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0
        for t in held:
            self.seen[t.untyped_storage()] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        return out

    def _track(self, st) -> None:
        if st in self.seen:
            return
        n = st.nbytes()
        self.seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def made_bytes(self, tree) -> int:
        """Bytes of the distinct storages of ``tree``'s tensors that were
        made under the mode."""
        sts = {id(t.untyped_storage()): t.untyped_storage()
               for t in _tensors(tree)}
        return sum(self.seen.get(st, 0) for st in sts.values())


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    sts = {id(t.untyped_storage()): t.untyped_storage().nbytes()
           for t in _tensors(tree)}
    return sum(sts.values())


def trace_step(step_fn, args) -> dict:
    """Run ``step_fn(*args)`` under ``FlopCounterMode`` and a
    ``StorageTracker``: {"flops", "temp_bytes" (peak of the bytes made
    above the arguments), "output_bytes" (the outputs' bytes made by the
    step), "trace_s"}. On ``meta`` tensors it computes nothing; on real
    tensors it runs the step (the card's check of the same figures)."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    tracker = StorageTracker(_tensors(args))
    with FlopCounterMode(display=False) as fc, tracker:
        out = step_fn(*args)
        out_bytes = tracker.made_bytes(out)
    flops = int(fc.get_total_flops())
    del out
    return {"flops": flops, "temp_bytes": tracker.peak,
            "output_bytes": out_bytes, "trace_s": time.perf_counter() - t0}


def argument_bytes(cfg, shape, args, n_cards: int = 1) -> int:
    """Per-card bytes of the step's arguments: every leaf once, but an
    expert leaf that ``param_specs`` splits over ``n_cards`` ranks counts
    its 1/n block (so do its AdamW moments, which lie like the params)."""
    from ..sharding import param_specs
    params = args[0]
    total = tree_bytes(args) - tree_bytes(params)
    specs = tree_leaves(param_specs(cfg, n_cards))
    split = [s is not None and n_cards > 1 for s in specs]
    for t, s in zip(tree_leaves(params), split):
        total += t.untyped_storage().nbytes() // (n_cards if s else 1)
    if shape.kind == "train":
        opt = args[1]
        total -= tree_bytes(opt["m"]) + tree_bytes(opt["v"])
        for mom in (opt["m"], opt["v"]):
            for t, s in zip(tree_leaves(mom), split):
                total += t.untyped_storage().nbytes() // (n_cards if s else 1)
    return total


def step_tokens(cfg, shape) -> int:
    """Tokens one MoE layer of the step routes (a decode step: one a
    row)."""
    from .specs import AUDIO_TGT_FRac
    if shape.kind == "decode":
        return shape.global_batch
    s = shape.seq_len
    if cfg.is_encoder_decoder:
        s //= AUDIO_TGT_FRac
    return shape.global_batch * s


def collective_bytes(cfg, shape, n_cards: int) -> int:
    """Per-card EP round bytes of one step over ``n_cards`` ranks: each MoE
    layer's ``ep_round_bytes``, of which a card sends 1/n. A train step
    counts the forward three times: the forward, its recompute under
    remat and the backward's transposed exchanges (the port has no EP
    backward yet: ROADMAP A5; this is what one would move)."""
    from ..models.transformer import moe_layer_count
    from ..roofline import ep_round_bytes
    from ..sharding import ep_size_for
    if n_cards <= 1 or ep_size_for(cfg, n_cards) is None:
        return 0
    per_layer = ep_round_bytes(cfg, step_tokens(cfg, shape), n_cards)
    passes = 3 if shape.kind == "train" else 1
    return passes * moe_layer_count(cfg) * per_layer // n_cards


def run_one(cfg_or_arch, shape, n_cards: int = 1,
            out_dir: str | None = None) -> dict:
    """The dry-run record of one (config x shape x card count).
    ``cfg_or_arch``: a ``ModelConfig`` or an arch id; ``shape``: an
    ``InputShape`` or a name from ``configs.SHAPES``."""
    return run_pair(cfg_or_arch, shape, (n_cards,), out_dir)[0]


def run_pair(cfg_or_arch, shape, cards=(1,),
             out_dir: str | None = None) -> list:
    """The dry-run records of one (config x shape), one for each card
    count in ``cards``: the step is traced once and its arguments built
    once for all of them."""
    from ..configs import SHAPES, get_config
    from . import specs as S

    cfg = (get_config(cfg_or_arch) if isinstance(cfg_or_arch, str)
           else cfg_or_arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if not S.supported(cfg, shape):
        return [{"arch": cfg.arch_id, "shape": shape.name, "cards": n,
                 "device": "meta",
                 "status": ("skipped (shape-skip matrix: long_500k needs a "
                            "sub-quadratic config)")} for n in cards]
    step_fn, args = S.step_args(cfg, shape)
    tr = trace_step(step_fn, args)
    return [_record(cfg, shape, n, tr,
                    argument_bytes(cfg, shape, args, n), out_dir)
            for n in cards]


def _record(cfg, shape, n_cards: int, tr: dict, arg_b: int,
            out_dir: str | None) -> dict:
    from ..roofline import roofline_report
    out_b = tr["output_bytes"]
    coll = collective_bytes(cfg, shape, n_cards)
    rec = dict(
        arch=cfg.arch_id, shape=shape.name, cards=n_cards, device="meta",
        status="ok", n_devices=n_cards, trace_s=round(tr["trace_s"], 2),
        memory={"argument_size_in_bytes": arg_b,
                "output_size_in_bytes": out_b,
                "temp_size_in_bytes": tr["temp_bytes"],
                "per_device_total_gib": round(
                    (arg_b + tr["temp_bytes"]) / 2**30, 3)},
        cost={"flops": tr["flops"], "bytes": arg_b,
              "collective_bytes": coll},
        figures={
            "traced": ["cost.flops", "memory.temp_size_in_bytes",
                       "memory.output_size_in_bytes"]
            + (["memory.argument_size_in_bytes"] if n_cards == 1 else []),
            "reckoned": (["memory.argument_size_in_bytes",
                          "cost.collective_bytes"] if n_cards > 1 else []),
            "note": ("flops and temp are the one-card trace's: the whole "
                     "step, an upper bound for one card (every card runs "
                     "the dense part over the whole batch; its experts are "
                     "1/n of the expert FFN)"
                     + ("; train collective bytes are reckoned for an EP "
                        "backward the port does not have yet"
                        if shape.kind == "train" else "")
                     if n_cards > 1 else "one card: everything traced")})
    # ``flops`` is the whole step's (the one-card trace), so MODEL_FLOPS
    # is not divided over the cards for the useful-FLOP ratio.
    rec["roofline"] = roofline_report(
        flops=tr["flops"], hbm_bytes=arg_b, collective_bytes=coll,
        n_devices=1, cfg=cfg, shape=shape, arg_bytes=arg_b, out_bytes=out_b)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{cfg.arch_id}_{shape.name}_{n_cards}cards.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


def run_mesh_pair(cfg_or_arch, shape, multi_pods=(False,),
                  out_dir: str | None = None) -> list:
    """The per-device records of one (config x shape) on the reference's
    production meshes, one for each of ``multi_pods`` (False: 16 x 16,
    True: 2 x 16 x 16). The one-card trace that a train or deferred pair
    falls back to is made once for all of them."""
    from ..configs import SHAPES, get_config
    from . import specs as S
    from .mesh import make_production_mesh

    cfg = (get_config(cfg_or_arch) if isinstance(cfg_or_arch, str)
           else cfg_or_arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    recs, one_card = [], None
    for mp in multi_pods:
        name = MESH_NAMES[mp]
        if not S.supported(cfg, shape):
            recs.append({"arch": cfg.arch_id, "shape": shape.name,
                         "mesh": name, "device": "meta",
                         "status": ("skipped (shape-skip matrix: long_500k "
                                    "needs a sub-quadratic config)")})
            continue
        mesh = make_production_mesh(multi_pod=mp)
        step, args, rm = S.lowering_args(cfg, shape, mesh)
        arg_b = tree_bytes(args)
        if step is not None:
            rm.collective_bytes = 0
            tr = trace_step(step, args)
            coll = rm.collective_bytes
        else:
            if one_card is None:
                one_card = trace_step(*S.step_args(cfg, shape))
            tr, coll = one_card, None
        del args
        recs.append(_mesh_record(cfg, shape, name, mesh.size, tr, arg_b,
                                 coll, out_dir))
    return recs


def _mesh_record(cfg, shape, name: str, n_dev: int, tr: dict, arg_b: int,
                 coll, out_dir: str | None) -> dict:
    from ..roofline import roofline_report
    out_b = tr["output_bytes"]
    traced = coll is not None
    if traced:
        figures = {
            "traced": ["cost.flops", "memory.temp_size_in_bytes",
                       "memory.output_size_in_bytes",
                       "cost.collective_bytes"],
            "exact": ["memory.argument_size_in_bytes"],
            "reckoned": [],
            "note": "rank 0's rank program on meta over a CountingMesh; "
                    "arguments are its shards; row-parallel partial sums "
                    "travel in fp32, so their all-reduces count twice the "
                    "bytes of the reference's, which sums them in the "
                    "activation dtype"}
    else:
        why = ("sharded training has no rank program yet (ROADMAP A5)"
               if shape.kind == "train" else
               "this family's rank program waits (ROADMAP A4)")
        figures = {
            "traced": [],
            "exact": ["memory.argument_size_in_bytes"],
            "reckoned": ["cost.flops", "memory.temp_size_in_bytes",
                         "memory.output_size_in_bytes"],
            "note": f"{why}: flops, temp and outputs are the one-card "
                    "trace's whole step, upper bounds for one device; no "
                    "collective bytes"}
    rec = dict(
        arch=cfg.arch_id, shape=shape.name, mesh=name, device="meta",
        status="ok", n_devices=n_dev, trace_s=round(tr["trace_s"], 2),
        memory={"argument_size_in_bytes": arg_b,
                "output_size_in_bytes": out_b,
                "temp_size_in_bytes": tr["temp_bytes"],
                "per_device_total_gib": round(
                    (arg_b + tr["temp_bytes"]) / 2**30, 3)},
        cost={"flops": tr["flops"], "bytes": arg_b,
              "collective_bytes": coll},
        figures=figures)
    rec["roofline"] = roofline_report(
        flops=tr["flops"], hbm_bytes=arg_b, collective_bytes=coll or 0,
        n_devices=n_dev if traced else 1, cfg=cfg, shape=shape,
        arg_bytes=arg_b, out_bytes=out_b)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{cfg.arch_id}_{shape.name}_{name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _print(tag: str, rec: dict) -> None:
    extra = ""
    if rec["status"] == "ok":
        roof = rec["roofline"]
        terms = " ".join(f"{k[:-2]} {roof[k] * 1e3:.4g} ms"
                         for k in ("compute_s", "memory_s", "collective_s"))
        per = "card" if "cards" in rec else "device"
        extra = (f"  trace {rec['trace_s']}s mem/{per} "
                 f"{rec['memory']['per_device_total_gib']} GiB "
                 f"{rec['cost']['flops'] / 1e12:.1f} TFLOP {terms} -> "
                 f"{roof['dominant']}")
    print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)


def main(argv=None) -> int:
    from ..configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(
        description="Trace each (arch x shape) step on the meta device.")
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cards", type=int, nargs="+", default=None,
                    help="EP layouts over this many cards (e.g. 1 4 8); "
                    "each pair is traced once for all of them (default 1 "
                    "without a mesh flag)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="per device of the 2x16x16 mesh (pod2x16x16)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="per device of the 16x16 and 2x16x16 meshes")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    meshes = ([False, True] if args.both_meshes
              else [True] if args.multi_pod else [])
    cards = args.cards if args.cards or meshes else [1]
    if cards and min(cards) < 1:
        ap.error("--cards must be >= 1")

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    print("[dryrun] device meta: abstract tensors, nothing allocated",
          flush=True)
    failures = 0
    for arch, shape in itertools.product(archs, shapes):
        runs = []
        if cards:
            runs.append(("card(s)", cards, lambda: run_pair(
                arch, shape, cards, out_dir=args.out)))
        if meshes:
            runs.append(("mesh", [MESH_NAMES[m] for m in meshes],
                         lambda: run_mesh_pair(arch, shape, meshes,
                                               out_dir=args.out)))
        for kind, names, run in runs:
            try:
                recs = run()
            except Exception:
                failures += 1
                for n in names:
                    print(f"[dryrun] {arch} x {shape} x {n} {kind}: FAILED",
                          flush=True)
                traceback.print_exc()
                continue
            for rec in recs:
                label = (f"{rec['cards']} card(s)" if "cards" in rec
                         else rec["mesh"])
                _print(f"{arch} x {shape} x {label}", rec)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

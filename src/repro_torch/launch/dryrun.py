"""Multi-pod dry run: run every (arch x shape x mesh) cell once over fake
tensors on a fake process group (``repro.launch.dryrun`` in the port).

The reference lowers and compiles each cell for 512 placeholder devices
and never executes it. Here each cell's train step, prefill or serve
step runs once, eagerly, as rank 0 of a fake group of 256 or 512 ranks
(``launch/mesh.make_production_mesh``) under ``FakeTensorMode``: every
parameter, cache and batch is a DTensor whose local shard is a fake
tensor, so nothing is allocated, no collective moves a byte and no card
is used. DTensor still plans every redistribution, so the collectives a
real run would issue are issued, and counted.

Cells run with ``impl="dense"``: the plain ops, never the hand-written
kernels (the reference's dry run lowers ``impl="xla"``, its plain XLA
ops, never its Pallas kernels; in the port ``"xla"`` means the kernels).

Per cell this records:
  - per-rank argument and output bytes, from the local shards;
  - no per-rank peak: ``MemTracker`` counts global-shaped tensors under
    fake DTensors (``PEAK_NOTE``);
  - FLOPs, ideal bytes and collective bytes by kind
    (``repro_torch.roofline.op_cost``), and the three roofline terms
    with the dominant one, against the H100's rates
    (``repro_torch.roofline.analysis``).

A cell that fails is written with ``ok: false`` and its error, and the
CLI then exits non-zero.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k \\
      --opt seqpar   # named sharding variants
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS, SHAPES, applicable_shapes, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model_for, sharding_hooks
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_cost import OpCost
from repro_torch.training import train_loop

DEC_LEN_TRAIN = 448  # whisper decoder length for the train shape
ENC_LEN_DECODE = 1500  # whisper encoder frames for decode shapes
DEFAULT_OUT = "build/dryrun"


# ---------------------------------------------------------------------------
# Optimization variants, applied as config/rule edits.
# ---------------------------------------------------------------------------


def apply_opt(cfg: ModelConfig, opt: Optional[str]) -> ModelConfig:
    if not opt or opt == "baseline":
        return cfg
    for o in opt.split("+"):
        if o == "no_remat":
            cfg = dataclasses.replace(cfg, remat=False)
        elif o == "remat":
            cfg = dataclasses.replace(cfg, remat=True)
        elif o == "moe_dense":
            cfg = dataclasses.replace(cfg, moe_dense=True)
        elif o in OPT_RULES or o == "moe_local":
            pass  # rule/hook-level variant, applied in run_cell
        else:
            raise ValueError(f"unknown opt variant {o}")
    return cfg


# Named sharding-rule variants, composable with '+', e.g.
# --opt kv_replicate+seqpar.
OPT_RULES: Dict[str, Dict[str, Dict]] = {
    # GQA/MHA kv_heads that don't divide the model axis fall back to
    # head_dim sharding in the baseline, which shards the attention
    # contraction dim; the variant replicates those projections instead.
    "kv_replicate": {"param": {"head_dim": []}},
    # Sequence parallelism: activations shard the sequence on the model axis.
    "seqpar": {"act": {"seq": ["model"], "batch": ["pod", "data"]}},
    # Decode activations shard d_model on data (batch tiny per step).
    "decode_dshard": {
        "act": {"batch": [], "embed": ["data"]},
        "cache": {"batch": ["model", "pod", "data"], "seq": ["data", "pod"]},
    },
    # Decode cache sequence sharding on the model axis.
    "cache_seq_model": {
        "cache": {"batch": ["pod", "data"], "seq": ["model"],
                  "kv_heads": [], "head_dim": []},
    },
}


def opt_rule_context(opt: Optional[str]):
    merged: Dict[str, Dict] = {"param": {}, "act": {}, "cache": {}}
    if opt:
        for o in opt.split("+"):
            for kind, upd in OPT_RULES.get(o, {}).items():
                merged[kind].update(upd)
    return shd.rule_overrides(param=merged["param"], act=merged["act"], cache=merged["cache"])


# ---------------------------------------------------------------------------
# Fake, sharded stand-ins
# ---------------------------------------------------------------------------


def fake_dtensor(meta: torch.Tensor, sharding: shd.NamedSharding,
                 requires_grad: bool = False) -> torch.Tensor:
    """A DTensor of ``meta``'s shape and dtype laid out by ``sharding``,
    its local shard a fake tensor on the CPU (call under FakeTensorMode)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(sharding.local_shape(meta.shape), dtype=meta.dtype)
    stride = tuple(math.prod(meta.shape[i + 1:]) for i in range(len(meta.shape)))
    out = DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                             shape=meta.shape, stride=stride)
    return out.requires_grad_(requires_grad)


def _fake_tree(meta_tree, shard_tree, requires_grad=False):
    if isinstance(meta_tree, dict):
        return {k: _fake_tree(meta_tree[k], shard_tree[k], requires_grad) for k in meta_tree}
    if isinstance(meta_tree, (list, tuple)):
        return [_fake_tree(m, s, requires_grad) for m, s in zip(meta_tree, shard_tree)]
    return fake_dtensor(meta_tree, shard_tree, requires_grad)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _act(mesh, shape, dtype, axes=None):
    return fake_dtensor(_meta(shape, dtype), train_loop.batch_sharding(mesh, shape, axes))


def input_specs(cfg: ModelConfig, shape_name: str, mesh, seq_len: Optional[int] = None,
                global_batch: Optional[int] = None) -> Tuple[Any, tuple]:
    """(fn, args): the cell's call and its fake, sharded arguments (call
    under FakeTensorMode). ``seq_len`` / ``global_batch`` override the
    shape's (tests run small)."""
    spec = SHAPES[shape_name]
    model = model_for(cfg)
    S = seq_len or spec.seq_len
    B = global_batch or spec.global_batch
    i32 = torch.int32

    if spec.kind == "train":
        step = train_loop.make_train_step(model, train_loop.TrainConfig())
        abstract = train_loop.abstract_state(model)
        sh = train_loop.shardings_for_state(model, mesh)
        state = train_loop.TrainState(
            params=_fake_tree(abstract.params, sh.params, requires_grad=True),
            opt=type(abstract.opt)(
                step=fake_dtensor(abstract.opt.step, sh.opt.step),
                m=_fake_tree(abstract.opt.m, sh.opt.m), v=_fake_tree(abstract.opt.v, sh.opt.v)))
        if cfg.encdec:
            batch = {"frames": _act(mesh, (B, S, cfg.d_model), cfg.dtype, ("batch", "seq", "embed")),
                     "dec_tokens": _act(mesh, (B, DEC_LEN_TRAIN), i32)}
        else:
            batch = {"tokens": _act(mesh, (B, S), i32)}
            if cfg.rope_kind == "mrope":
                batch["positions"] = _act(mesh, (3, B, S), i32, (None, "batch", "seq"))
        return step, (state, batch)

    params = _fake_tree(model.abstract_params(), shd.tree_shardings(
        model.abstract_params(), model.axes(), mesh))
    if spec.kind == "prefill":
        if cfg.encdec:
            def prefill(params, frames, dec_tokens):
                logits, _ = model.forward(params, frames, dec_tokens)
                return sharding_hooks.replicate(logits[:, -1]).argmax(-1)

            return prefill, (params, _act(mesh, (B, S, cfg.d_model), cfg.dtype,
                                          ("batch", "seq", "embed")),
                             _act(mesh, (B, DEC_LEN_TRAIN), i32))
        if cfg.rope_kind == "mrope":
            def prefill(params, tokens, positions):
                logits, _ = model.forward(params, tokens, positions)
                return sharding_hooks.replicate(logits[:, -1]).argmax(-1)

            return prefill, (params, _act(mesh, (B, S), i32),
                             _act(mesh, (3, B, S), i32, (None, "batch", "seq")))

        def prefill(params, tokens):
            logits, _ = model.forward(params, tokens)
            return sharding_hooks.replicate(logits[:, -1]).argmax(-1)

        return prefill, (params, _act(mesh, (B, S), i32))

    # decode shapes: one new token against a seq_len cache (serve_step)
    if cfg.encdec:
        meta_cache = model.init_cache(B, S, ENC_LEN_DECODE, device="meta")
    else:
        meta_cache = model.init_cache(B, S, device="meta")
    cache = _fake_tree(meta_cache, shd.cache_shardings(meta_cache, cfg, mesh))

    def serve_step(params, cache, token, cursor):
        return model.decode_step(params, cache, token, cursor)

    return serve_step, (params, cache, _act(mesh, (B,), i32), _act(mesh, (B,), i32))


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def _local_bytes(tree) -> int:
    total = 0
    for t in _flat(tree):
        local = t._local_tensor if shd.is_dtensor(t) else t
        total += math.prod(local.shape) * local.element_size()
    return total


def _flat(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return []


# MemTracker (torch.distributed._tools.mem_tracker) cannot give a rank's
# peak here: under fake DTensors it counts global-shaped tensors (DTensor's
# shape runs and outputs), not the rank's shards. On the 16 x 16 fake mesh
# a (1024, 1024) x (1024, 512) float32 product, whose local output is
# (64, 32) (8192 bytes), read 8388608 bytes.
PEAK_NOTE = ("no per-rank peak: MemTracker counts global-shaped tensors under fake "
             "DTensors (see launch/dryrun.py)")


def run_cell(arch: str, shape_name: str, multi_pod: bool, opt: Optional[str] = None, *,
             cfg: Optional[ModelConfig] = None, seq_len: Optional[int] = None,
             global_batch: Optional[int] = None) -> Dict[str, Any]:
    """Run one cell on a fake group; ``cfg``, ``seq_len`` and
    ``global_batch`` override the arch's config and the shape's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = apply_opt(cfg or get_config(arch), opt)
    cfg = dataclasses.replace(cfg, impl="dense")
    mesh = make_production_mesh(multi_pod=multi_pod)
    spec = SHAPES[shape_name]
    S = seq_len or spec.seq_len
    B = global_batch or spec.global_batch
    t0 = time.time()
    with opt_rule_context(opt):
        shd.install_activation_resolver(mesh)
        if opt and "moe_local" in opt:
            sharding_hooks.set_moe_mesh(mesh)
        try:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args = input_specs(cfg, shape_name, mesh, S, B)
                arg_bytes = _local_bytes(args)
                t_build = time.time() - t0
                grad = contextlib.nullcontext() if spec.kind == "train" else torch.no_grad()
                with OpCost() as counter, shd.mesh_mode(), grad:
                    out = fn(*args)
                out_bytes = _local_bytes(out)
            t_run = time.time() - t0 - t_build
        finally:
            shd.clear_activation_resolver()
            sharding_hooks.clear_moe_mesh()

    mem = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
           "peak_note": PEAK_NOTE}
    counts = counter.result()
    n = math.prod(mesh.mesh.shape)
    model_flops = roofline.model_flops_for(cfg, spec.kind, S, B)
    report = roofline.analyze(counts, model_flops_global=model_flops, n_devices=n)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "opt": opt or "baseline",
        "ok": True,
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory_analysis": mem,
        "roofline": report.to_dict(),
        "counts": counts,
        "constants": {"peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
                      "link_bw": roofline.LINK_BW,
                      "note": "reckoned from the H100 SXM data sheet at 700 W; not measured"},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default=None, help="optimization variant")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in applicable_shapes(get_config(arch)):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for multi in meshes:
            tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
            if args.opt:
                tag += f"_{args.opt}"
            t0 = time.time()
            try:
                result = run_cell(arch, shape, multi, args.opt)
                r = result["roofline"]
                m = result["memory_analysis"]
                print(
                    f"OK   {tag}: {time.time() - t0:.1f}s args/rank="
                    f"{m['argument_size_in_bytes']} dominant={r['dominant']} "
                    f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                    f"collective={r['collective_s']:.3e}s",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 - every cell is recorded
                failures += 1
                result = {
                    "arch": arch,
                    "shape": shape,
                    "mesh": "2x16x16" if multi else "16x16",
                    "opt": args.opt or "baseline",
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}"[:2000],
                    "traceback": traceback.format_exc()[-3000:],
                }
                print(f"FAIL {tag}: {time.time() - t0:.1f}s {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:300] if str(e) else ''}", flush=True)
            with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
                json.dump(result, f, indent=1)
    if failures:
        raise SystemExit(f"{failures} dry-run cell(s) failed")


if __name__ == "__main__":
    main()

"""Multi-pod dry-run on the meta device: prove that every (architecture x
input-shape x mesh) cell runs on the stacked production mesh, and take the
roofline inputs from that run (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step for 256 or 512
fake host devices and reads XLA's analyses. The port has no compiler: it
runs the cell's own step functions (``make_train_step``,
``make_prefill_step``, ``make_decode_step``, ``init_state``) at full width
on ``device="meta"``, where every tensor has a shape, a dtype and strides
but no memory and no data. The parameters, the optimizer state, the cache
and the batch are laid out there (``bridge.device_params``), every rank of
the mesh stacked on dim 0 as on the card, and the step runs op for op.
Each kernel's wrapper gives a meta tensor an empty output of its shape
(``ring_allgather``, ``ring_allgather_transpose``, ``matmul``; the
``repro_torch::rank_matmul`` op has a fake), and the decode cache's write
is one scatter with no data-dependent shape. So the dry-run runs on the
meta device by design, as the reference runs on fake devices: the
``--device`` default of the other entry points does not apply.

Per cell a JSON record with the reference's keys:
  - ``memory_analysis``: per rank, from a dispatch mode that follows every
    storage the step makes until it dies (``_StepTracker``).
    ``argument_size_in_bytes`` is what one rank holds of the step's
    inputs: one shard of a leaf split over the mesh, the whole of a leaf
    that is replicated (the trainable layout keeps such a leaf once, and
    the ranked layout expands one tensor over the ranks; each rank of a
    real mesh holds a copy, as XLA's per-device analysis counts it), 1/R
    of the global decode cache (its batch split over dp, its heads or its
    sequence over ``model``) and 1/dp of a batch that splits over dp.
    ``temp_size_in_bytes`` is the peak, over the step, of the bytes the
    step has made and that are still alive, over R ranks (a stacked
    temporary is R ranks' tensors). ``output_size_in_bytes`` is what the
    step returns, at these rates (an input updated in place at its
    argument rate). ``peak_bytes`` = arguments + temporaries, per rank;
    ``process_peak_bytes`` the same for the whole stacked process (every
    storage once), which is what ``torch.cuda.max_memory_allocated``
    measures of the step on one card.
  - ``cost_analysis_raw.flops``: the step's flops by ``FlopCounterMode``'s
    formulas (its ``flop_registry``, ``rank_matmul``'s registered beside
    torch's), forward, recompute and backward, every executed op once.
  - ``collectives_hlo``: the collective bytes the step executes, by kind
    (``launch/collective_stats.py``, hlo_stats's formulas and keys;
    ``hlo_bytes`` is None: there is no HLO text).
  - ``analytic``: ``launch/analytic_costs.py``, the reference's model.
  - ``fits`` (the port's one extra field): per-rank peak <= the card's
    memory, ``torch.cuda.get_device_properties(0).total_memory`` where a
    card is present, else ``CARD_MEMORY_BYTES``, measured on one.
  - ``lower_s``: laying out the inputs and building the step;
    ``compile_s``: running the step on meta.

Elementwise ops on meta tensors take their shapes from Python reference
implementations, 0.1 to 0.2 ms an op; the tracker caches each functional
op's output shape, strides, dtype and flops by its inputs' (a blockwise
prefill at 32k runs the same few shapes tens of thousands of times), and
makes a cached output with ``torch.empty_strided``. Several cells run side
by side, each in a process of its own (one a core).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out dryrun_results/
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import bridge
from repro_torch.configs import (SHAPES, cell_supported, get_model_config, iter_cells,
                                 make_run_config)
from repro_torch.launch import analytic_costs, collective_stats
from repro_torch.launch.mesh import StackedMesh, make_production_mesh
from repro_torch.models.layers import dtype_of
from repro_torch.models.model_builder import batch_dims
from repro_torch.sharding.fsdp import global_shape
from repro_torch.sharding.specs import Stacked, shard_axes, tree_leaves

META = torch.device("meta")

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (power limit 700.00 W), printed by ``chip_smoke.py``'s phase 7
CARD_MEMORY_BYTES = 85_017_493_504
CARD_NAME = "NVIDIA H100 80GB HBM3"


def card_memory() -> tuple[int, str]:
    """(bytes, name) of the card ``fits`` is judged against: the live
    card's where CUDA is available, else the recorded H100's."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return CARD_MEMORY_BYTES, CARD_NAME


def _key(a):
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_key(x) for x in a)
    if isinstance(a, dict):
        return tuple((k, _key(v)) for k, v in sorted(a.items()))
    return a


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _StepTracker(TorchDispatchMode):
    """Every op of a step on meta tensors: its flops, and the storages it
    makes, each followed until it dies (a weak reference to the storage,
    which autograd's saved tensors and views keep alive), the live bytes'
    peak kept. Storages alive when the tracker starts (``hold``) are the
    step's arguments and not counted as made. Functional ops' outputs
    are cached by their inputs' shapes, strides and dtypes."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}
        self._held: set[int] = set()
        self._cache: dict = {}
        self._functional: dict = {}
        self._formulas = FlopCounterMode(display=False).flop_registry

    def hold(self, tensors) -> int:
        """Mark the storages of ``tensors`` as arguments; returns their
        bytes, each storage once."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self._held:
                self._held.add(st._cdata)
                total += st.nbytes()
        return total

    def _free(self, cdata: int) -> None:
        self.live -= self._sizes.pop(cdata)

    def _made(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            cd = st._cdata
            if cd in self._sizes or cd in self._held:
                continue
            n = st.nbytes()
            self._sizes[cd] = n
            weakref.finalize(st, self._free, cd)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _is_functional(self, func) -> bool:
        ok = self._functional.get(func)
        if ok is None:
            s = func._schema
            ok = (not s.is_mutable and len(s.returns) > 0
                  and all(r.alias_info is None and str(r.type) == "Tensor" for r in s.returns))
            self._functional[func] = ok
        return ok

    def _count(self, func, args, kwargs, out) -> int:
        formula = self._formulas.get(func._overloadpacket)
        return formula(*args, **kwargs, out_val=out) if formula else 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._is_functional(func):
            out = func(*args, **kwargs)
            self.flops += self._count(func, args, kwargs, out)
            self._made(out)
            return out
        key = (func, _key(args), _key(kwargs))
        hit = self._cache.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            flops = self._count(func, args, kwargs, out)
            if all(isinstance(o, torch.Tensor) and o.is_meta for o in outs):
                self._cache[key] = (isinstance(out, tuple), flops,
                                    tuple((o.shape, o.stride(), o.dtype) for o in outs))
        else:
            is_tuple, flops, specs = hit
            outs = tuple(torch.empty_strided(s, st, dtype=d, device=META) for s, st, d in specs)
            out = outs if is_tuple else outs[0]
        self.flops += flops
        self._made(out)
        return out


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _trainable_bytes(leaf: Stacked) -> int:
    """One rank's bytes of a leaf of the trainable layout: one shard, or
    the whole leaf where nothing splits it."""
    n = math.prod(leaf.mesh.shape[a] for a in shard_axes(leaf.spec, leaf.mesh))
    return _nbytes(global_shape(leaf), leaf.local.dtype) // n


def _ranked_bytes(leaf: Stacked) -> int:
    """One rank's bytes of a leaf of the ranked layout (R, *local)."""
    return _nbytes(leaf.local.shape[1:], leaf.local.dtype)


def _batch(run, dev) -> dict:
    out = {}
    for name, shp in batch_dims(run.model, run.shape).items():
        dt = (torch.long if name in ("tokens", "targets", "token", "pos")
              else dtype_of(run.model.compute_dtype))
        out[name] = torch.empty(shp, dtype=dt, device=dev)
    return out


class _Cell:
    """A cell's step on meta tensors: its arguments, their bytes per rank
    by storage, and the step as a function of no arguments."""

    def __init__(self, run, mesh: StackedMesh):
        from repro_torch.runtime import serve_loop, train_loop

        self.run, self.mesh = run, mesh
        cfg, kind = run.model, run.shape.kind
        dp = math.prod(mesh.shape[a] for a in mesh.dp_rank_axes)
        params = bridge.device_params(cfg, mesh, run.mesh, seed=run.train.seed,
                                      dtype=dtype_of(cfg.param_dtype), device=META)
        batch = _batch(run, META)
        split = run.shape.global_batch % dp == 0
        self.per_rank: dict[int, float] = {}
        for t in batch.values():
            self._arg(t, t.nbytes / dp if split else t.nbytes)
        if kind == "train":
            _, _, step = train_loop.make_train_step(run, mesh, device=META)
            state = train_loop.init_state(run, mesh, params, device=META)
            for tree in (state.params, state.opt.m, state.opt.v):
                for leaf in tree_leaves(tree):
                    self._arg(leaf.local, _trainable_bytes(leaf))
            self.args = (state, batch)
            self.step = lambda: step(state, batch)
            return
        if run.collective.serve_params_replicated:
            params = serve_loop.serving_params(params, run, mesh)
        for leaf in tree_leaves(params):
            self._arg(leaf.local, _ranked_bytes(leaf))
        if kind == "prefill":
            _, _, prefill = serve_loop.make_prefill_step(run, mesh, device=META)
            self.args = (params, batch)
            self.step = lambda: prefill(params, batch)
            return
        api, _, decode = serve_loop.make_decode_step(run, mesh, device=META)
        b = run.shape.global_batch
        cache = api.init_cache(b, run.shape.seq_len)
        for t in _tensors(cache):
            self._arg(t, t.nbytes / mesh.n_ranks)
        state = serve_loop.ServeState(cache, torch.empty((b,), dtype=torch.long, device=META))
        self._arg(state.pos, state.pos.nbytes / dp if split else state.pos.nbytes)
        self.args = (params, state, batch)
        self.step = lambda: decode(params, state, batch["token"])

    def _arg(self, t: torch.Tensor, per_rank: float) -> None:
        """An argument tensor and one rank's bytes of it; views of one
        storage (a leaf expanded over the ranks) count once."""
        self.per_rank.setdefault(t.untyped_storage()._cdata, per_rank)

    def rank_bytes(self, tensors, n_ranks: int) -> float:
        """One rank's bytes of the storages of ``tensors``: an argument's at
        its rate, any other storage over the ranks."""
        seen, total = set(), 0.0
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            total += self.per_rank.get(st._cdata, st.nbytes() / n_ranks)
        return total


def measure_step(run, mesh: StackedMesh) -> dict:
    """Run the cell's step once on meta tensors under the tracker and the
    collective counters. Returns the memory (per rank and for the whole
    process), the flops, the collective stats and the two times."""
    t0 = time.monotonic()
    cell = _Cell(run, mesh)
    tracker = _StepTracker()
    arg_process = tracker.hold(_tensors(cell.args))
    t1 = time.monotonic()
    n_dev = math.prod(mesh.shape.values())
    with collective_stats.counting(n_devices=n_dev) as st, tracker:
        out = cell.step()
    t2 = time.monotonic()
    r = mesh.n_ranks
    arg = cell.rank_bytes(_tensors(cell.args), r)
    temp = tracker.peak / r
    return {
        "memory_analysis": {
            "argument_size_in_bytes": int(arg),
            "output_size_in_bytes": int(cell.rank_bytes(_tensors(out), r)),
            "temp_size_in_bytes": int(temp),
            "generated_code_size_in_bytes": 0,
            "peak_bytes": int(arg + temp),
            "process_argument_bytes": arg_process,
            "process_peak_bytes": arg_process + tracker.peak,
        },
        "flops": tracker.flops,
        "collectives": st,
        "lower_s": t1 - t0,
        "compile_s": t2 - t1,
    }


def describe(mesh: StackedMesh) -> dict:
    return {"shape": dict(mesh.shape), "n_devices": math.prod(mesh.shape.values()),
            "platform": "meta", "stacked_ranks": mesh.n_ranks}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             fsdp_mode: str = "xla", grad_accum: int = 1,
             remat: str = "full", collect_hlo: bool = True,
             mesh_shape: tuple[int, int] | None = None,
             serve_replicate: bool = False,
             moe_groups: int = 0,
             kv_int8: bool = False,
             prefetch: bool = False) -> dict:
    """mesh_shape: regroup the same ranks as (dp, tp) — a §Perf knob (the
    mesh shape is a software view of the physical pod). ``collect_hlo``
    keeps the reference's name: it turns the collective counters on."""
    t_start = time.monotonic()
    run = make_run_config(arch, shape_name, multi_pod=multi_pod)
    model = run.model
    if moe_groups and model.moe is not None:
        model = dataclasses.replace(
            model, moe=dataclasses.replace(model.moe, routing_groups=moe_groups)
        )
    if kv_int8:
        model = dataclasses.replace(model, kv_cache_dtype="int8")
    run = run.replace(
        model=model,
        train=dataclasses.replace(run.train, grad_accum=grad_accum, remat=remat),
        collective=dataclasses.replace(
            run.collective, fsdp_mode=fsdp_mode,
            serve_params_replicated=serve_replicate, prefetch=prefetch,
        ),
    )
    if mesh_shape is not None:
        assert not multi_pod, "mesh regrouping is a single-pod perf knob"
        mesh = StackedMesh(data=mesh_shape[0], model=mesh_shape[1])
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = math.prod(mesh.shape.values())
    rec: dict = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "fsdp_mode": fsdp_mode, "grad_accum": grad_accum, "remat": remat,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "serve_replicate": serve_replicate, "moe_groups": moe_groups,
        "mesh": describe(mesh), "ok": False,
    }
    try:
        m = measure_step(run, mesh)
        rec["lower_s"] = round(m["lower_s"], 2)
        rec["compile_s"] = round(m["compile_s"], 2)
        rec["memory_analysis"] = m["memory_analysis"]
        rec["cost_analysis_raw"] = {"flops": float(m["flops"])}
        if collect_hlo:
            rec["collectives_hlo"] = m["collectives"].as_dict()
            rec["hlo_bytes"] = None
        mem, name = card_memory()
        rec["fits"] = m["memory_analysis"]["peak_bytes"] <= mem
        rec["card"] = {"name": name, "total_memory": mem}

        # analytic roofline inputs
        cfg, shape = run.model, run.shape
        tp = mesh.shape["model"]
        cc = analytic_costs.cell_cost(
            cfg, shape, n_dev, remat=remat,
            tp=tp, serve_replicated=serve_replicate,
        )
        dp = n_dev // tp
        epx = 1.0
        if moe_groups and cfg.moe is not None:
            # cross-EP copies per token: bounded by the active group count
            # instead of top_k (DeepSeek-V3 device-limited routing)
            epx = min(cfg.moe.routing_group_topk, cfg.moe.top_k) / cfg.moe.top_k
        cl = analytic_costs.collective_cost(
            cfg, shape, dp=dp, tp=tp, remat=remat, grad_accum=grad_accum,
            ep_crossing_factor=epx, serve_replicated=serve_replicate,
        )
        rec["analytic"] = {
            "model_flops": cc.model_flops,
            "impl_flops": cc.impl_flops,
            "useful_ratio": cc.useful_ratio,
            "hbm_bytes_per_device": cc.hbm_bytes,
            "params_total": cc.params_total,
            "params_active": cc.params_active,
            "collective_bytes_per_device": {
                "fsdp_allgather": cl.fsdp_allgather,
                "grad_reduce_scatter": cl.grad_reduce_scatter,
                "tp_activations": cl.tp_activations,
                "ep_all_to_all": cl.ep_all_to_all,
                "decode_psum": cl.decode_psum,
                "total": cl.total,
            },
        }
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.monotonic() - t_start, 2)
    return rec


def _tag(args, arch: str, shape: str, mesh_shape) -> str:
    tag = f"{arch}__{shape}__{'2pod' if args.multi_pod else '1pod'}"
    variant = []
    if args.fsdp_mode != "xla":
        variant.append(args.fsdp_mode)
    if args.grad_accum != 1:
        variant.append(f"a{args.grad_accum}")
    if args.remat != "full":
        variant.append(args.remat)
    if mesh_shape:
        variant.append(f"m{mesh_shape[0]}x{mesh_shape[1]}")
    if args.serve_replicate:
        variant.append("srvrep")
    if args.moe_groups:
        variant.append(f"g{args.moe_groups}")
    if args.kv_int8:
        variant.append("kvi8")
    if args.prefetch:
        variant.append("pf")
    if variant:
        tag += "__" + "_".join(variant)
    return tag


def _one(job) -> dict:
    arch, shape, kw = job
    return run_cell(arch, shape, **kw)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fsdp-mode", default="xla")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--mesh-shape", default=None,
                    help="regroup the pod, e.g. 64x4 (dp x tp)")
    ap.add_argument("--serve-replicate", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-hlo", action="store_true")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh_shape:
        mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x"))
        assert len(mesh_shape) == 2 and mesh_shape[0] * mesh_shape[1] == 256

    cells = []
    if args.all:
        for arch, shape, ok, why in iter_cells(include_skipped=True):
            if ok:
                cells.append((arch, shape))
            else:
                print(f"SKIP {arch} x {shape}: {why}", flush=True)
    else:
        ok, why = cell_supported(get_model_config(args.arch), SHAPES[args.shape])
        if not ok:
            print(f"SKIP: {why}")
            sys.exit(0)
        cells.append((args.arch, args.shape))

    kw = dict(multi_pod=args.multi_pod, fsdp_mode=args.fsdp_mode,
              grad_accum=args.grad_accum, remat=args.remat, collect_hlo=not args.no_hlo,
              mesh_shape=mesh_shape, serve_replicate=args.serve_replicate,
              moe_groups=args.moe_groups, kv_int8=args.kv_int8, prefetch=args.prefetch)
    jobs = [(arch, shape, kw) for arch, shape in cells]
    workers = min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers, torch.set_num_threads, (1,)) as pool:
            results = _report(args, pool.imap(_one, jobs), mesh_shape)
    else:
        results = _report(args, map(_one, jobs), mesh_shape)
    n_bad = sum(not r["ok"] for r in results)
    print(f"[dryrun] done: {len(results) - n_bad}/{len(results)} OK", flush=True)
    sys.exit(1 if n_bad else 0)


def _report(args, records, mesh_shape) -> list[dict]:
    results = []
    for rec in records:
        arch, shape = rec["arch"], rec["shape"]
        status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')})"
        print(f"[dryrun] {arch} x {shape} multi_pod={args.multi_pod}: {status} "
              f"(lower {rec.get('lower_s')}s compile {rec.get('compile_s')}s)",
              flush=True)
        results.append(rec)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, _tag(args, arch, shape, mesh_shape) + ".json"),
                      "w") as f:
                json.dump(rec, f, indent=1)
    return results


if __name__ == "__main__":
    main()

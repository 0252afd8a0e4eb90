#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. the ring-step kernel (csrc/ring_step.cu) against its plain torch version,
   bitwise, over ranks, lengths, dtypes, directions and round masks;
2. the stacked allgathers (ring, bidi, bcast) against the plain gather;
3. serving smollm-135m at full width and depth (30 layers, bf16, seeded
   random weights) on a (data=8, model=1) stacked mesh: prefill of a
   128-token prompt for batch 8, then greedy generation of 32 tokens, in
   every fsdp_mode. All modes must give identical logits and tokens, and
   the kernel's launch count must rise in exactly the mcast modes. A reduced
   f32 model is also held against a single-rank run.

Prints the card's name and power limit, per-mode timings (medians of
host-clock samples; decode is timed on its own), the ring step's times
beside its HBM bound, a JSON line of kernels, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero if any check fails or
there is no CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig,  # noqa: E402
                                 ShapeConfig, get_model_config, reduced)
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.kernels import ring_allgather as K  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate,  # noqa: E402
                                            make_decode_step, make_prefill_step)
from repro_torch.sharding.specs import is_sharded, tree_leaves  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
MODES = ("xla", "mcast", "mcast_ring", "mcast_bcast")
N_CHAINS = 2
BATCH, PROMPT, NEW = 8, 128, 32
REPEATS = 5   # host-clock samples per timed phase; the median is reported


def check_kernel() -> tuple[int, float]:
    """Phase 1: kernel vs plain step, bitwise. Returns (cases, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, max_err = 0, 0.0
    for p in (2, 4, 8):
        # 13824, 41472 and 110592: the rank-slot lengths of smollm-135m's
        # sharded leaves at P=8 (wk/wv, wq/wo, MLP)
        for n in (1, 7, 13824, 41472, 110592, 110592 + 3):
            variants = [dict(), dict(direction=-1), dict(split=n // 2),
                        dict(direction=-1, split=n // 2)]
            if p > 2:
                variants += [dict(rounds=p // 2, active_round=r) for r in range(p // 2)]
            for dtype in (torch.bfloat16, torch.float32):
                for groups in (1, 2):
                    for kw in variants:
                        for s in range(p - 1):
                            buf = torch.randn((groups, p, p, n), generator=gen,
                                              device="cuda").to(dtype)
                            want = K.ring_step_plain(buf.clone(), s, **kw)
                            got = K.ring_step(buf, s, **kw)
                            torch.cuda.synchronize()
                            err = (got.float() - want.float()).abs().max().item()
                            max_err = max(max_err, err)
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"ring_step != plain: P={p} n={n} {dtype} G={groups} "
                                    f"{kw} step {s}: max err {err}")
                            cases += 1
    return cases, max_err


def check_collectives() -> int:
    """Phase 2: the paper's stacked allgathers equal the plain gather."""
    mesh = StackedMesh(data=8, model=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    for n in (1, 7, 13824, 110592 + 3):
        x = torch.randn((8, n), generator=gen, device="cuda").to(torch.bfloat16)
        want = C.make_allgather(mesh, "data", "xla")(x)
        for mode, chains in (("ring", None), ("bidi", None), ("bcast", N_CHAINS)):
            got = C.make_allgather(mesh, "data", mode, n_chains=chains)(x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{mode} allgather != plain gather at n={n}")
            cases += 1
    return cases


def check_small_reference() -> float:
    """Reduced smollm-135m in f32: the sharded mcast prefill and generation
    against a single-rank run of the same weights (no gather at all)."""
    cfg = reduced(get_model_config("smollm-135m"))
    tree = bridge.random_params(cfg, seed=1)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (8, 32))).cuda()
    outs = {}
    for mesh in (None, StackedMesh(data=8, model=1)):
        params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", "prefill", 32, 8),
                        collective=CollectiveConfig(fsdp_mode="mcast"))
        _, _, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)
        logits, _ = prefill(params, {"tokens": tokens})
        toks = greedy_generate(prefill, decode, params, tokens, 8, 40)
        outs[mesh is None] = (logits, toks)
    err = (outs[True][0] - outs[False][0]).abs().max().item()
    if not err <= 1e-4:   # f32 sums batched differently: rounding only
        raise AssertionError(f"sharded vs single-rank prefill differ by {err}")
    if not torch.equal(outs[True][1], outs[False][1]):
        raise AssertionError("sharded vs single-rank greedy tokens differ")
    return err


def serve() -> int:
    """Phase 3: the main path in every mode. Returns its ring-step launches."""
    cfg = get_model_config("smollm-135m")
    mesh = StackedMesh(data=8, model=1)
    t0 = time.perf_counter()
    params = bridge.to_torch(bridge.random_params(cfg, seed=0), mesh,
                             MeshConfig(), dtype=torch.bfloat16)
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model {cfg.d_model}, weights "
          f"built in {time.perf_counter() - t0:.3f} s", flush=True)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT))).cuda()
    n_sharded = sum(1 for leaf in tree_leaves(params["blocks"])
                    if is_sharded(leaf.spec, ("data",)))
    ref = None
    K.launches = 0   # counts from here are the main path's
    for mode in MODES:
        run = RunConfig(model=cfg, shape=ShapeConfig("serve", "prefill", PROMPT, BATCH),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS))
        _, _, prefill = make_prefill_step(run, mesh)
        _, _, decode = make_decode_step(run, mesh)

        def do_prefill():
            return prefill(params, {"tokens": tokens})

        def do_generate():
            return greedy_generate(prefill, decode, params, tokens, NEW, PROMPT + NEW)

        do_prefill()   # warm-up
        (logits, pre), _, launches = _run(do_prefill)
        out, _, gen_launches = _run(do_generate)
        prefill_s = _wall(do_prefill)
        dev_prefill, prefill_prof_ms = _device_times(do_prefill)
        busy_ms = sum(dev_prefill.values())
        ring_ms = sum(t for k, t in dev_prefill.items() if "ring_step_kernel" in k)

        # decode on its own: the NEW - 1 steps of greedy_generate, from the
        # prefilled cache (rewritten in place with the same values each call)
        cache = {k: F.pad(v, (0, 0, 0, NEW)) for k, v in pre.items()}
        pos0, tok0 = torch.full((BATCH,), PROMPT, device="cuda"), logits.argmax(-1)

        def do_decode():
            state, tok = ServeState(cache, pos0), tok0
            for _ in range(NEW - 1):
                step_logits, state = decode(params, state, tok)
                tok = step_logits.argmax(-1)
            return tok

        if not torch.equal(do_decode(), out[:, -1]):
            raise AssertionError(f"{mode}: decode loop disagrees with greedy_generate")
        decode_s = _wall(do_decode)
        dev_decode, decode_prof_ms = _device_times(do_decode)
        decode_busy_ms = sum(dev_decode.values())

        if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"{mode}: bad logits {tuple(logits.shape)}")
        if out.shape != (BATCH, PROMPT + NEW) or not torch.equal(out[:, :PROMPT], tokens):
            raise AssertionError(f"{mode}: bad generated tokens {tuple(out.shape)}")
        steps = cfg.num_layers * n_sharded * (mesh.n_ranks - 1)   # one ring per leaf
        want = {"xla": 0, "mcast": steps, "mcast_ring": steps,
                "mcast_bcast": steps * (mesh.n_ranks // N_CHAINS)}[mode]
        if launches != want or gen_launches != want:
            raise AssertionError(f"{mode}: {launches} ring-step launches per prefill and "
                                 f"{gen_launches} in generation, expected {want}")
        if ref is None:
            ref = (logits, out)
        diff = (logits.float() - ref[0].float()).abs().max().item()
        if diff != 0 or not torch.equal(out, ref[1]):
            raise AssertionError(f"{mode} differs from xla: logits max diff {diff}")
        # idle shares: busy time and wall time of the same profiled call
        row = {"mode": mode,
               "prefill_ms_median": statistics.median(prefill_s) * 1e3,
               "prefill_ms_samples": [t * 1e3 for t in prefill_s],
               "ring_step_launches_per_prefill": launches,
               "prefill_device_busy_ms": busy_ms,
               "prefill_profiled_wall_ms": prefill_prof_ms,
               "prefill_device_idle_share": 1 - busy_ms / prefill_prof_ms,
               "prefill_ring_step_device_ms": ring_ms,
               "decode_steps": NEW - 1,
               "decode_ms_median": statistics.median(decode_s) * 1e3,
               "decode_ms_samples": [t * 1e3 for t in decode_s],
               "decode_tok_s": BATCH * (NEW - 1) / statistics.median(decode_s),
               "decode_device_busy_ms": decode_busy_ms,
               "decode_profiled_wall_ms": decode_prof_ms,
               "decode_device_idle_share": 1 - decode_busy_ms / decode_prof_ms,
               "max_abs_logit_diff_vs_xla": diff,
               "sample_tokens": out[0, PROMPT:PROMPT + 8].tolist()}
        print("[serve] " + json.dumps(row), flush=True)
        top = sorted(dev_prefill.items(), key=lambda kv: -kv[1])[:6]
        print(f"[serve] {mode} prefill, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return K.launches


def _run(fn):
    """(result, wall seconds, ring-step launches) of one synchronised call."""
    torch.cuda.synchronize()
    before, t0 = K.launches, time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, K.launches - before


def _wall(fn, repeats: int = REPEATS) -> list[float]:
    """Host seconds of each of ``repeats`` synchronised calls of ``fn``."""
    return [_run(fn)[1] for _ in range(repeats)]


def _device_times(fn, iters: int = 1) -> tuple[dict[str, float], float]:
    """Device ms per call of each kernel (and memcpy / memset) that ``fn``
    runs, by name, from the profiler's CUDA records; and the wall ms per call
    of those same profiled calls."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    return ({e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
             if e.self_device_time_total}, wall_ms)


def _time(fn, iters: int = 200) -> float:
    """ms per call: CUDA events around ``iters`` back-to-back calls."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ring_step(cfg) -> dict:
    """The ring step at the shapes of one smollm-135m layer at P=8 (the flat
    rank shard of each sharded leaf), one unidirectional step per call:
    kernel, plain version, and one advanced-index copy of the same step."""
    p = 8
    d, f, q, kv = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim, \
        cfg.num_kv_heads * cfg.head_dim
    shapes = {"wq": d * q, "wk": d * kv, "wv": d * kv, "wo": q * d,
              "w_gate": d * f, "w_up": d * f, "w_down": f * d}
    rank = torch.arange(p, device="cuda")
    src, rcv = rank % p, (rank + 1) % p   # step 0: rank d sends its own slot
    tot: dict = {}
    for name, numel in shapes.items():
        n = numel // p
        buf = torch.randn((p, p, n), device="cuda").to(torch.bfloat16)
        fns = {"": lambda: K.ring_step(buf, 0),
               "bidi_": lambda: K.ring_step(buf, 0, split=n // 2),
               "plain_": lambda: K.ring_step_plain(buf, 0),
               "library_": lambda: buf.index_put_((rcv, src), buf[rank, src])}
        row = {f"{k}ms": _time(fn) for k, fn in fns.items()}
        row.update({f"{k}device_ms": sum(_device_times(fn, 50)[0].values()) or None
                    for k, fn in fns.items()})
        row["bound_ms"] = 2 * p * n * buf.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"[ring_step] {name}: P={p} n={n} bf16 " + json.dumps(row), flush=True)
        for k, v in row.items():
            if v is not None and tot.get(k, 0.0) is not None:
                tot[k] = tot.get(k, 0.0) + v / len(shapes)
            else:
                tot[k] = None
    return tot


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    cases, max_err = check_kernel()
    print(f"[kernel] ring_step == plain on {cases} cases, max abs err {max_err} "
          f"({time.perf_counter() - t0:.1f} s incl. build)", flush=True)
    print(f"[collectives] {check_collectives()} cases equal the "
          "plain gather", flush=True)
    err = check_small_reference()
    print(f"[reference] reduced f32 sharded vs single-rank: max abs logit diff {err}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    launches = serve()
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    timing = time_ring_step(get_model_config("smollm-135m"))
    print(f"[ring_step] mean over one layer's leaves: {json.dumps(timing)}", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "ring_step", "route": "cuda", "source": "src/repro_torch/csrc/ring_step.cu",
        "replaces": "src/repro/kernels/ring_allgather.py:46", "launches": launches,
        "max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

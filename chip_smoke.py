#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

0. builds the seven kernel sources (csrc/*.cu), one nvcc each, in parallel;
1. the ring step (one entry of the ring-allgather kernel,
   csrc/ring_allgather.cu, on the buffer in place) against its plain torch
   version, bitwise, over ranks, lengths, dtypes, directions and round
   masks; the
   order check of the ring-allgather kernel (csrc/ring_allgather.cu): for
   every prefix length k (0 included) of the ring (both directions) and
   bidi schedules at P = 2, 3, 5, 8 and 33, of the broadcasts' (M = 1, 2,
   4) and a mixed schedule at P = 8, and of the broadcasts' with one chain
   at P = 16 (240 entries: a launch per 128), the call on the first k
   entries equals the shards installed on the diagonal and then k plain
   ring steps, on the same buffer of random values, bitwise (bf16 and f32;
   n = 1, 7, 24, 41,472 and 41,473; one and two groups); the same order
   check of the transpose kernel (csrc/ring_allgather_transpose.cu) over
   the same schedules and prefixes against its plain version (a copy of the
   cotangent, the plain transposed steps in reverse order, the diagonal),
   bitwise, f16 too at n = 24, the two-group cotangent a non-contiguous
   view, max(1, ceil(k / 128)) launches a call; the
   matmul kernel (csrc/matmul.cu) against its plain version at every shape
   the training and serving paths give it (forward and both backward
   products, bf16 and f32, the tied head's embed^T view included): f32
   within 1e-5 x max|plain|, bf16 within 1e-2 x max|plain|, every bf16
   product on the wgmma + TMA path; then that path's edge cases (the four
   operand layouts at one 128 x 192 tile, ragged M, N and K, operands
   expanded over the ranks, out= views) and the wmma path's (K = 33, N = 7,
   a base off 16 bytes), on integer inputs, bitwise; the receive
   datapath's kernels against their plain versions, all exactly
   (torch.equal): the pool scan with its RNR mask (csrc/pool.cu, f64, rows
   1 to 511, rows up to 16389 long, 1 to 16 workers, +inf-padded ragged rows
   and tied arrivals), bitmap pack, OR across rows and popcount
   (csrc/bitmap.cu, up to 512 rows and 2^20 flags; the OR also on every
   pair of 0, 1, 2, 31, 32, 33, 511, 512 and 4,096 rows by 1, 3, 4, 5, 512,
   513 and 32,768 words, all zero, all ones, one bit in the last row and
   word, sparse random words, and those as a view whose base is off 16
   bytes; popcount rows on both sides of its one-strip limit, and empty,
   with no bit, one bit and random bits set), chunk reassembly (csrc/chunk_reassembly.cu: int32 and
   int64 PSNs, duplicate PSNs, n_valid below n_staged and 0, four dtypes,
   4096-byte chunks and an odd width); then the reassembly and popcount
   wrappers under ``torch.cuda.set_sync_debug_mode("error")``: none may
   synchronise with the host;
2. the stacked allgathers (ring, bidi, bcast) against the plain gather;
3. serving smollm-135m at full width and depth (30 layers, bf16, seeded
   random weights) on a (data=8, model=1) stacked mesh: prefill of a
   128-token prompt for batch 8, then greedy generation of 32 tokens, in
   every fsdp_mode. All modes must give identical logits and tokens; each
   gather of the mcast modes is one ring-allgather launch (210 per prefill)
   that runs its mode's schedule (bidi, ring, broadcasts: 1,470 / 1,470 /
   5,880 entries), no ring step is launched, and no product may reach the
   wmma or f32 kernel. A
   reduced f32 model is also held against a single-rank run;
4. training smollm-135m at full width (30 layers, bf16, batch 16 x 512,
   remat="full") on the same mesh in every fsdp_mode: one warm-up step and
   3 timed steps each; the first step's loss must be bitwise equal in all
   modes; a step launches 420 ring-allgather kernels running 2,940 / 2,940
   / 11,760 schedule entries of its mode's kind in mcast / mcast_ring /
   mcast_bcast, and 210 transpose kernels (one per gather backward) running
   1,470 / 1,470 / 5,880, no ring step, no transposed step, and the
   matmuls as before.
   A reduced f32 train step sharded
   over 8 ranks is held against a single-rank run over 3 steps (loss within
   1e-5, grad_norm within 1e-4, relative);
4b. the training path's options at the same width, batch and mesh:
   ``CollectiveConfig(prefetch=True)`` with remat="full", remat="dots", both
   together (mcast), and prefetch in mcast_bcast, beside phase 4's mcast
   step; each a warm-up, then 3 rounds of one timed step of every variant
   (the order reversed each round), then a profiled step. A step launches
   a gather per leaf and layer in the forward and again in each
   checkpointed body (29 bodies under prefetch: layer 0's gather and the
   last block lie outside them), 210 transposes, and the matmuls less the
   forward products that no "full" body runs again (dots keeps them all):
   420 / 413 / 420 / 413 / 413 gathers and 844 / 837 / 634 / 634 / 837
   matmuls; the first-step loss bitwise phase 4's, the grad norms within
   1e-4 relative of phase 4's; under prefetch the profiler must show the
   gathers on a stream that no matmul runs on. Prints the step ms, the
   device idle share, the device ms of the matmuls, gathers and
   transposes, the device ms of gathers and transposes that ran while
   another stream worked, and the peak memory;
5. the packet-level reliable Broadcast (core/packet.py) with the leaves'
   receive datapath on the card: A, 512 hosts x 64 MiB, 8 workers, 1e-3
   Bernoulli loss per leaf, seed 0; B, 64 hosts x 64 MiB, 1 worker (the
   staging ring overflows), Gilbert-Elliott loss at 1 % in bursts of 8,
   seed 4; both with 1 us jitter and aggregated NACKs. Each must equal the
   same call's CPU run field for field (delivery orders and round traces
   included). Then every one of A's 511 leaves replays its delivery order
   (``protocol.reassemble``, on chunk reassembly) into a zeroed buffer,
   which must equal the root's, its bitmap packed and counted to 16384
   chunks;
6. the collective layer's remaining entry points, each driven once with the
   launch counts zeroed before and read after: (a) the double-buffered
   drain (csrc/double_buffer_drain.cu) equal to its plain version on every
   case (torch.equal: the received shards of (b), the reference test's
   shapes, odd shapes in uint8 and int32, views off a 16-byte boundary);
   (b) ``make_allgather_matmul`` at smollm-135m's widths, bf16, on the
   (data=8, model=1) mesh, 128 and 1,024 rows per rank times each of the
   block's projections 576 -> 576, 576 -> 192, 576 -> 1536 and 1536 -> 576,
   each call one launch of the wgmma kernel that reads every rank's shard
   in place (no ring step): bitwise equal to the plain gather followed by
   the same kernel, within the matmul's limits of the plain product; the
   same calls with ``use_pallas=False``, the reference's ``jnp.dot``
   branch: the ring schedule, seven ring steps and plain products a call,
   within the same limits; its
   times beside the ring schedule's on one stream (the ring steps and
   2P - 1 products), the plain and library times and the bound, and the
   device's busy time and idle share; (c)
   ``make_broadcast`` of ``flatten_bucket`` over layer 0 (about 3.5 M f32)
   from roots 0 and 7 in 8 and 64 chunks, every rank bitwise equal to
   root's row; (d) ``concurrent_ag_rs_local`` on that bucket's shards, both
   halves bitwise equal to the separate calls, on two streams and on one:
   one ring-allgather launch of the whole ring schedule on the side stream
   and one launch of its transpose on the current one, no ring step (counts
   zeroed before, read after); the ring steps of (b)'s ``use_pallas=False``
   calls are the kernels line's launches of the ring step: the serving and
   training paths launch none.

Prints the card's name and power limit, per-mode and per-broadcast timings
(medians of host-clock samples after a warm-up call; device busy time and
idle share from the profiler; the CPU run's wall times, taken the same
way, beside each broadcast),
each kernel's times beside its bound, a JSON line of kernels, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero if any check
fails or there is no CUDA device.
"""
from __future__ import annotations

import bisect
import dataclasses
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
                                 ShapeConfig, TrainConfig, get_model_config, reduced)
from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import packet as PK  # noqa: E402
from repro_torch.core import protocol  # noqa: E402
from repro_torch.data.pipeline import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import bitmap as BM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import chunk_reassembly as CR  # noqa: E402
from repro_torch.kernels import collective_matmul as M  # noqa: E402
from repro_torch.kernels import pool as PL  # noqa: E402
from repro_torch.kernels import ring_allgather as K  # noqa: E402
from repro_torch.launch.mesh import StackedMesh  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate,  # noqa: E402
                                            make_decode_step, make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step  # noqa: E402
from repro_torch.sharding.fsdp import flatten_bucket  # noqa: E402
from repro_torch.sharding.specs import is_sharded, tree_leaves  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor / f32 FMA
MODES = ("xla", "mcast", "mcast_ring", "mcast_bcast")
N_CHAINS = 2
BATCH, PROMPT, NEW = 8, 128, 32
TRAIN_SHAPE = ShapeConfig("train", "train", 512, 16)
TRAIN_TIMED = 3
REPEATS = 5   # host-clock samples per timed phase; the median is reported


def check_kernel() -> tuple[int, float]:
    """Phase 1: the ring step (a one-entry launch of the gather's kernel) vs
    its plain step, bitwise. Returns (cases, max abs err)."""
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


def _mixed_schedule(n: int) -> tuple:
    """Entries of every kind in no schedule's order, at P = 8: whole slots,
    splits at 0, inside and at n, both directions, round masks."""
    return ((0, 1, None, 1, 0), (1, 1, n // 3, 1, 0), (2, -1, 0, 1, 0), (0, -1, n, 2, 1),
            (3, 1, n // 2, 4, 3), (6, -1, min(1, n), 1, 0), (5, 1, n, 8, 5))


def _order_schedules(p: int, n: int) -> dict[str, tuple]:
    if p == 16:   # more entries than a launch carries
        return {"bcast1": C._bcast_schedule(p, 1)}
    out = {"ring": C._ring_schedule(p), "ring-": C._ring_schedule(p, -1),
           "bidi": C._bidi_schedule(p, n)}
    if p == 8:
        out.update({f"bcast{m}": C._bcast_schedule(p, m) for m in (1, 2, 4)})
        out["mixed"] = _mixed_schedule(n)
    return out


def check_allgather() -> tuple[int, float]:
    """Phase 1: the order check of the ring-allgather kernel. For every
    prefix length k of every schedule, k = 0 included, the call on its
    first k entries (one launch per 128) equals the shards installed on the
    diagonal and then k plain steps, on the same buffer of random values,
    bitwise: every slot, reached or not. Returns (launches, max abs err)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    launches, max_err = 0, 0.0
    for p in (2, 3, 5, 8, 16, 33):   # 33: more ranks than a warp's lanes, the wide kernel
        for dtype in (torch.bfloat16, torch.float32):
            for n in (1, 7, 24, 41472, 41473):
                for name, sched in _order_schedules(p, n).items():
                    for groups in (1, 2):
                        x = torch.randn((groups, p, n), generator=gen, device="cuda").to(dtype)
                        buf = torch.randn((groups, p, p, n), generator=gen,
                                          device="cuda").to(dtype)
                        want = buf.clone()
                        want.diagonal(dim1=-3, dim2=-2).copy_(x.transpose(-1, -2))
                        for k in range(len(sched) + 1):
                            if k:
                                step, direction, split, rounds, active = sched[k - 1]
                                K.ring_step_plain(want, step, direction=direction, split=split,
                                                  rounds=rounds, active_round=active)
                            before = K.allgather_launches
                            got = K.ring_allgather(x, sched[:k], out=buf.clone())
                            torch.cuda.synchronize()
                            max_err = max(max_err, _exact("ring_allgather", (got,), (want,),
                                                          (p, dtype, n, name, groups, k)))
                            if K.allgather_launches - before != max(1, -(-k // 128)):
                                raise AssertionError(f"ring_allgather: {k} entries took "
                                                     f"{K.allgather_launches - before} launches")
                            launches += K.allgather_launches - before
    return launches, max_err


def check_allgather_transpose() -> tuple[int, float]:
    """Phase 1: the order check of the transpose kernel. For every prefix
    length k of every schedule, k = 0 included, the call on its first k
    entries (one launch per 128) equals the plain version on the same
    cotangent, bitwise: bf16 and f32 at every n of ``check_allgather``, f16
    at n = 24; one group contiguous, two as a transposed view (copied by
    the wrapper); the cotangent unchanged. Returns (launches, max abs
    err)."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    launches, max_err = 0, 0.0
    sizes = [(dtype, n) for dtype in (torch.bfloat16, torch.float32)
             for n in (1, 7, 24, 41472, 41473)] + [(torch.float16, 24)]
    for p in (2, 3, 5, 8, 16, 33):
        for dtype, n in sizes:
            for name, sched in _order_schedules(p, n).items():
                for groups in (1, 2):
                    g = torch.randn((groups, p, n, p), generator=gen,
                                    device="cuda").to(dtype).transpose(-1, -2)
                    g = g if groups == 2 else g.contiguous()
                    kept = g.clone()
                    for k in range(len(sched) + 1):
                        want = K.ring_allgather_transpose_plain(g, sched[:k])
                        before = K.allgather_transpose_launches
                        got = K.ring_allgather_transpose(g, sched[:k])
                        torch.cuda.synchronize()
                        max_err = max(max_err, _exact("ring_allgather_transpose", (got,), (want,),
                                                      (p, dtype, n, name, groups, k)))
                        if K.allgather_transpose_launches - before != max(1, -(-k // 128)):
                            raise AssertionError(
                                f"ring_allgather_transpose: {k} entries took "
                                f"{K.allgather_transpose_launches - before} launches")
                        launches += K.allgather_transpose_launches - before
                    if not torch.equal(g, kept):
                        raise AssertionError(f"ring_allgather_transpose wrote its cotangent at "
                                             f"{(p, dtype, n, name, groups)}")
    return launches, max_err


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


def serve() -> None:
    """Phase 3: the serving path in every mode."""
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
        (logits, pre), _, counts = _run(do_prefill)
        out, _, gen_counts = _run(do_generate)
        launches, gen_launches = counts["ring_allgather"], gen_counts["ring_allgather"]
        if counts["matmul"] == 0 or any(counts[k] or gen_counts[k] for k in OFF_PATH + (
                "ring_step", "ring_allgather_transpose")):
            raise AssertionError(f"{mode}: prefill launched {counts}, generation {gen_counts}")
        prefill_s = _wall(do_prefill)
        dev_prefill, prefill_prof_ms = _device_times(do_prefill)
        busy_ms = sum(dev_prefill.values())
        ring_ms = sum(t for k, t in dev_prefill.items() if "ring_allgather_kernel" in k)
        matmul_ms = sum(t for k, t in dev_prefill.items() if "matmul_" in k)

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
        gathers = cfg.num_layers * n_sharded   # one per sharded leaf
        want = 0 if mode == "xla" else gathers
        entries = _want_entries(mode, gathers * (mesh.n_ranks - 1), mesh.n_ranks)
        if (launches != want or gen_launches != want or _entries(counts) != entries
                or _entries(gen_counts) != entries):
            raise AssertionError(f"{mode}: {launches} ring-allgather launches per prefill and "
                                 f"{gen_launches} in generation, expected {want}; schedule "
                                 f"entries {_entries(counts)} and {_entries(gen_counts)}, "
                                 f"expected {entries}")
        if ref is None:
            ref = (logits, out)
        diff = (logits.float() - ref[0].float()).abs().max().item()
        if diff != 0 or not torch.equal(out, ref[1]):
            raise AssertionError(f"{mode} differs from xla: logits max diff {diff}")
        # idle shares: busy time and wall time of the same profiled call
        row = {"mode": mode,
               "prefill_ms_median": statistics.median(prefill_s) * 1e3,
               "prefill_ms_samples": [t * 1e3 for t in prefill_s],
               "ring_allgather_launches_per_prefill": launches,
               "schedule_entries_per_prefill": _entries(counts),
               "matmul_launches_per_prefill": counts["matmul"],
               "prefill_device_busy_ms": busy_ms,
               "prefill_profiled_wall_ms": prefill_prof_ms,
               "prefill_device_idle_share": 1 - busy_ms / prefill_prof_ms,
               "prefill_ring_allgather_device_ms": ring_ms,
               "prefill_matmul_device_ms": matmul_ms,
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


MODEL_KERNELS = ("ring_allgather", "ring_allgather_transpose", "matmul")
# the kind of schedule entry each mode's gathers run (mcast: the bidirectional ring)
ENTRY_KIND = {"mcast": "bidi", "mcast_ring": "ring", "mcast_bcast": "bcast"}
OFF_PATH = ("matmul_wmma", "matmul_f32")   # matmul paths no main-path product takes
PACKET_KERNELS = ("pool", "bitmap_pack", "bitmap_or_rows", "bitmap_popcount",
                  "chunk_reassembly")
LAYER_KERNELS = ("allgather_matmul", "double_buffer_drain")
# the pool check's worker counts: one lane, A's 8, 16, odd counts, and the
# kernel's largest (S = 1, two lanes a thread)
POOL_WORKERS = (1, 7, 8, 16, 1000, 1024)
# csrc/bitmap.cu's kStripWords: a popcount row of up to this many words is
# one block, which stores its count; a longer one several, which add theirs
POPCOUNT_STRIP_WORDS = 4096
# the OR check's grid: rows within, at and past a block's lanes and its
# pass (128 and 512 rows); word counts off the vector path (1, 3, 5, 513),
# on it (4, A's 512) and of many tiles (32,768)
OR_ROWS = (0, 1, 2, 31, 32, 33, 511, 512, 4096)
OR_WORDS = (1, 3, 4, 5, 512, 513, 32768)


def _entries(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if k.startswith("entries_")}


def _want_entries(mode: str, steps: int, p: int, key: str = "entries") -> dict[str, int]:
    """Schedule entries that gathers (or their transposes) of ``steps`` ring
    steps in all run in ``mode`` over P = p ranks: one per step, on each of
    P / M rounds for the broadcasts; keyed ``{key}_{kind}``."""
    out = {f"{key}_{kind}": 0 for kind in K.entries}
    if mode != "xla":
        rounds = p // N_CHAINS if mode == "mcast_bcast" else 1
        out[f"{key}_{ENTRY_KIND[mode]}"] = steps * rounds
    return out


def _counts() -> dict[str, int]:
    return {"ring_allgather": K.allgather_launches,
            **{f"entries_{kind}": n for kind, n in K.entries.items()},
            "ring_allgather_transpose": K.allgather_transpose_launches,
            **{f"transpose_entries_{kind}": n for kind, n in K.transpose_entries.items()},
            "ring_step": K.launches,
            "matmul": M.launches, "matmul_wmma": M.launches_wmma,
            "matmul_f32": M.launches_f32, "pool": PL.launches, "bitmap_pack": BM.pack_launches,
            "bitmap_or_rows": BM.or_launches, "bitmap_popcount": BM.popcount_launches,
            "chunk_reassembly": CR.launches, "allgather_matmul": M.allgather_launches,
            "double_buffer_drain": K.drain_launches}


def _zero_counts() -> None:
    K.allgather_launches = K.allgather_transpose_launches = 0
    K.entries.update(dict.fromkeys(K.entries, 0))
    K.transpose_entries.update(dict.fromkeys(K.transpose_entries, 0))
    K.launches = M.launches = PL.launches = CR.launches = 0
    M.launches_wmma = M.launches_f32 = 0
    BM.pack_launches = BM.or_launches = BM.popcount_launches = 0
    M.allgather_launches = K.drain_launches = 0


def _run(fn):
    """(result, wall seconds, kernel launches by name) of one synchronised call."""
    torch.cuda.synchronize()
    before, t0 = _counts(), time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt, {k: v - before[k] for k, v in _counts().items()}


def _wall(fn, repeats: int = REPEATS) -> list[float]:
    """Host seconds of each of ``repeats`` synchronised calls of ``fn``."""
    return [_run(fn)[1] for _ in range(repeats)]


def _profiled(fn, iters: int = 1) -> tuple[dict[str, float], float, list[tuple]]:
    """Device ms per call of each kernel (and memcpy / memset) that ``fn``
    runs, by name, from the profiler's CUDA records; the wall ms per call
    of those same profiled calls; and every device record as (name, stream,
    start ms, end ms)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    records = [(e.name(), e.device_resource_id(), e.start_ns() / 1e6,
                (e.start_ns() + e.duration_ns()) / 1e6)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
    return ({e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
             if e.self_device_time_total}, wall_ms, records)


def _device_times(fn, iters: int = 1) -> tuple[dict[str, float], float]:
    """``_profiled`` without the records."""
    dev, wall_ms, _ = _profiled(fn, iters)
    return dev, wall_ms


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(span) for span in out]


def _overlap(records: list[tuple], names: tuple[str, ...]) -> dict:
    """Of the device records whose name holds one of ``names``: their
    streams, their device ms, and the ms of them that run while a record of
    another stream runs (the overlap of the prefetched gathers with the
    blocks). Also the busy ms of the device: the union of every record."""
    picked = [r for r in records if any(n in r[0] for n in names)]
    streams = {r[1] for r in picked}
    overlap = 0.0
    for stream in streams:
        others = _union([(lo, hi) for _, st, lo, hi in records if st != stream])
        starts = [lo for lo, _ in others]
        for _, st, lo, hi in picked:
            if st != stream:
                continue
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(others) and others[i][0] < hi:
                overlap += max(0.0, min(hi, others[i][1]) - max(lo, others[i][0]))
                i += 1
    return {"streams": sorted(streams),
            "all_streams": sorted({r[1] for r in records}),
            "device_ms": sum(hi - lo for _, _, lo, hi in picked),
            "overlap_ms": overlap,
            "busy_ms": sum(hi - lo for lo, hi in _union([(lo, hi) for *_, lo, hi in records]))}


def _time(fn, target_s: float = 0.05) -> float:
    """ms per call: CUDA events around back-to-back calls, as many as fill
    about ``target_s`` (at least 3, at most 200), after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(3, target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    for _ in range(min(iters, 10)):
        fn()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layer_leaves(cfg) -> dict[str, tuple[int, int]]:
    """(fan-in, fan-out) of each projection of one dense layer."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _steps(x: torch.Tensor, sched: tuple) -> torch.Tensor:
    """The gather as the main path ran it before the one-launch kernel: the
    zeroed ring buffer with the shards copied in, then one ring-step launch
    per schedule entry (each now a one-entry launch of the gather's own
    kernel, csrc/ring_allgather.cu, which serves ``ring_step``)."""
    buf = C._ring_buffer(x)
    for step, direction, split, rounds, active in sched:
        K.ring_step(buf, step, direction=direction, split=split, rounds=rounds,
                    active_round=active)
    return buf


def time_ring_steps(cfg) -> dict:
    """At the shapes of one smollm-135m layer at P=8 (the flat rank shard of
    each sharded leaf, bf16): the whole gather of each mode's schedule
    (``mcast``: bidi, ``mcast_ring``: ring, ``mcast_bcast``: M = 2) as the
    main path calls it, ``ring_allgather(x, schedule)``: the output's
    allocation and one launch that installs the shards and runs the
    schedule; ms per call from Python and device ms, beside what it
    replaces (the zeroed buffer, the shards' copy and 7 or 28 ring-step
    launches, ``_steps``), its plain version (the install and the plain steps) and the
    plain gather (``plain_allgather_local``, one tensor op: the library
    call), and the bound: (P * P + P) * n * 2 bytes, the shards read once
    and the gathered buffer written once. The same for each schedule's
    whole backward as the main path calls it, ``_transposed(g, schedule)``
    on a cotangent (P, P * n): the result's allocation and one launch of
    the transpose kernel; beside its plain version (a copy of the
    cotangent, the plain transposed steps in reverse order, the diagonal),
    which it must equal bitwise, the one PyTorch call of the same function,
    ``g.view(P, P, n).sum(-3)`` (not bitwise: it sums in another order),
    and the bound: (P * P + P) * n * 2 bytes, the cotangent read once and
    the result written once. Then one step per call of the ring step (a
    one-entry launch of the gather's kernel): kernel, plain version, and
    one library call of the same step (an advanced-index copy). Device ms
    from ``_device_ms``. Returns the means over the leaves (and, for the
    gather and its transpose, over the three schedules)."""
    p = 8
    rank = torch.arange(p, device="cuda")
    src, rcv = rank % p, (rank + 1) % p   # step 0: rank d sends its own slot
    leaves = _layer_leaves(cfg)
    tot: dict = {}
    for name, (fan_in, fan_out) in leaves.items():
        n = fan_in * fan_out // p
        x = torch.randn((p, n), device="cuda").to(torch.bfloat16)
        buf = C._ring_buffer(x)   # the ring step's buffer
        row = {"bound_ms": 2 * p * n * buf.element_size() / HBM_BYTES_PER_S * 1e3,
               "gather_bound_ms": (p * p + p) * n * buf.element_size() / HBM_BYTES_PER_S * 1e3,
               "gather_library_ms": _time(lambda: C.plain_allgather_local(x)),
               "gather_library_device_ms": _device_ms(lambda: C.plain_allgather_local(x))}
        g = torch.randn((p, p * n), device="cuda").to(torch.bfloat16)   # a layer's cotangent
        g3 = g.view(p, p, n)
        row.update({"transpose_bound_ms": row["gather_bound_ms"],
                    "transpose_library_ms": _time(lambda: g3.sum(-3)),
                    "transpose_library_device_ms": _device_ms(lambda: g3.sum(-3))})
        gather = {}
        for mode, sched in (("mcast", C._bidi_schedule(p, n)), ("mcast_ring", C._ring_schedule(p)),
                            ("mcast_bcast", C._bcast_schedule(p, N_CHAINS))):
            one = {"ms": lambda: K.ring_allgather(x, sched),
                   "replaced_ms": lambda: _steps(x, sched),
                   "plain_ms": lambda: K.ring_allgather_plain(x, sched)}
            gather[mode] = {"entries": len(sched),
                            **{k: _time(fn) for k, fn in one.items()},
                            "device_ms": _device_ms(one["ms"]),
                            "replaced_device_ms": _device_ms(one["replaced_ms"]),
                            "host_ms": _host_ms(one["ms"])}
        row["gather"] = gather
        transpose = {}
        for mode, sched in (("mcast", C._bidi_schedule(p, n)), ("mcast_ring", C._ring_schedule(p)),
                            ("mcast_bcast", C._bcast_schedule(p, N_CHAINS))):
            one = {"ms": lambda: C._transposed(g, sched),
                   "plain_ms": lambda: K.ring_allgather_transpose_plain(g3, sched)}
            if not torch.equal(one["ms"](), one["plain_ms"]()):
                raise AssertionError(f"{name} {mode}: the one-launch backward differs from its "
                                     "plain version")
            transpose[mode] = {"entries": len(sched),
                               **{k: _time(fn) for k, fn in one.items()},
                               "device_ms": _device_ms(one["ms"]),
                               "host_ms": _host_ms(one["ms"])}
        row["transpose"] = transpose
        for k in ("ms", "plain_ms", "device_ms"):
            row[f"gather_{k}"] = statistics.mean(v[k] for v in gather.values())
            row[f"transpose_{k}"] = statistics.mean(v[k] for v in transpose.values())
        fns = {"": lambda: K.ring_step(buf, 0),
               "bidi_": lambda: K.ring_step(buf, 0, split=n // 2),
               "plain_": lambda: K.ring_step_plain(buf, 0),
               "library_": lambda: buf.index_put_((rcv, src), buf[rank, src])}
        row.update({f"{k}ms": _time(fn) for k, fn in fns.items()})
        row.update({f"{k}device_ms": _device_ms(fn) for k, fn in fns.items()
                    if k in ("", "library_")})
        print(f"[ring] {name}: P={p} n={n} bf16 " + json.dumps(row), flush=True)
        for k, v in row.items():
            if k in ("gather", "transpose"):
                for mode, per in v.items():
                    for pk, pv in per.items():
                        key = f"{k}_{mode}_{pk}"
                        tot[key] = tot.get(key, 0.0) + pv / len(leaves)
            else:
                tot[k] = tot.get(k, 0.0) + v / len(leaves)
    return tot


# ------------------------------------------------------------------ matmul


def _operand(r: int, rows: int, cols: int, transposed: bool, dtype, gen) -> torch.Tensor:
    """(r, rows, cols), or the transposed view of a contiguous (r, cols, rows)."""
    if transposed:
        return torch.randn((r, cols, rows), device="cuda", generator=gen).to(dtype).transpose(1, 2)
    return torch.randn((r, rows, cols), device="cuda", generator=gen).to(dtype)


def matmul_cases(cfg, r: int, m: int, dtype, *, train: bool,
                 head_m: int | None = None) -> dict:
    """Every matmul the path launches per step: {(r, m, k, n, a_t, b_t,
    dtype): launches}, a_t / b_t marking an operand given as a transposed
    view. ``m`` is the tokens per rank, ``head_m`` the head's rows per rank
    (default ``m``; a prefill's last position). With ``train`` (remat="full"), each
    layer's forward products run twice (the checkpointed recompute), then
    dY W^T and X^T dY; the head's forward runs twice (the checkpointed
    cross-entropy chunk), then its two backward products."""
    cases: dict = {}

    def add(key, count):
        cases[key] = cases.get(key, 0) + count

    for k, n in _layer_leaves(cfg).values():
        add((r, m, k, n, False, False, dtype), cfg.num_layers * (2 if train else 1))
        if train:
            add((r, m, n, k, False, True, dtype), cfg.num_layers)    # dY W^T
            add((r, k, m, n, True, False, dtype), cfg.num_layers)    # X^T dY
    d, v = cfg.d_model, cfg.vocab_size
    m = m if head_m is None else head_m
    add((r, m, d, v, False, True, dtype), 2 if train else 1)         # x embed^T
    if train:
        add((r, m, v, d, False, False, dtype), 1)                    # dY embed
        add((r, d, m, v, True, False, dtype), 1)                     # x^T dY
    return cases


def check_matmul(cases) -> float:
    """Phase 1: the kernel vs its plain version at every case, every bf16
    product on the wgmma path (one launch each). Returns the max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    for (r, m, k, n, a_t, b_t, dtype) in cases:
        a = _operand(r, m, k, a_t, dtype, gen)
        b = _operand(r, k, n, b_t, dtype, gen)
        want = M.matmul_plain(a, b)
        kind, before = M.path(a, b), M.launches
        got = M.matmul(a, b)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16 and (kind != "wgmma" or M.launches != before + 1):
            raise AssertionError(f"bf16 matmul {(r, m, k, n, a_t, b_t)} took the {kind} path")
        err = (got.float() - want.float()).abs().max().item()
        tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * want.float().abs().max().item()
        if not err <= tol or got.dtype != dtype:
            raise AssertionError(f"matmul != plain at {(r, m, k, n, a_t, b_t, dtype)}: "
                                 f"max err {err} > {tol}")
        max_err = max(max_err, err)
    return max_err


def _ints(*shape, gen) -> torch.Tensor:
    """Integers in [-2, 2] as bf16: every f32 sum of their products is exact."""
    return torch.randint(-2, 3, shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_matmul_edges() -> int:
    """Phase 1: the edge cases of the two bf16 paths, on integer inputs so
    that each result must equal the plain product bitwise: the four operand
    layouts at one 128 x 192 tile and at ragged M, N, K; odd extents where
    not contiguous; operands expanded over the ranks; out= views; and what
    TMA cannot describe (K = 33, N = 7 MN-major, a base off 16 bytes) on the
    wmma kernel. Returns the number of cases."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def operand(r, rows, cols, transposed):
        return (_ints(r, cols, rows, gen=gen).transpose(1, 2) if transposed
                else _ints(r, rows, cols, gen=gen))

    cases = []   # (a, b, out, path)
    for a_t in (False, True):
        for b_t in (False, True):
            for r, m, k, n in ((1, 128, 64, 192), (2, 136, 72, 200), (1, 1000, 520, 584)):
                cases.append((operand(r, m, k, a_t), operand(r, k, n, b_t), None, "wgmma"))
    cases += [(operand(2, 65, 72, False), operand(2, 72, 7, True), None, "wgmma"),
              (_ints(1024, 576, gen=gen).expand(8, 1024, 576),
               _ints(576, 192, gen=gen).expand(8, 576, 192), None, "wgmma")]
    a, b = _ints(2, 130, 64, gen=gen), _ints(2, 64, 200, gen=gen)
    for out in (torch.zeros(2, 200, 130, dtype=torch.bfloat16, device="cuda").transpose(1, 2),
                torch.zeros(2 * 130 * 200 + 1, dtype=torch.bfloat16, device="cuda")[1:]
                .view(2, 130, 200),
                torch.zeros(2, 130, 202, dtype=torch.bfloat16, device="cuda")[:, :, :200],
                torch.zeros(2, 130, 456, dtype=torch.bfloat16, device="cuda")[:, :, 256:]):
        cases.append((a, b, out, "wgmma"))
    off = torch.zeros(2 * 40 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(2, 40, 64)
    off.copy_(_ints(2, 40, 64, gen=gen))
    cases += [(_ints(2, 40, 33, gen=gen), _ints(2, 33, 64, gen=gen), None, "wmma"),
              (_ints(2, 40, 64, gen=gen), _ints(2, 64, 7, gen=gen), None, "wmma"),
              (off, _ints(2, 64, 64, gen=gen), None, "wmma")]
    for a, b, out, kind in cases:
        case = (tuple(a.shape), a.stride(), tuple(b.shape), b.stride())
        before = (M.launches, M.launches_wmma)
        got = M.matmul(a, b, out=out)
        torch.cuda.synchronize()
        took = "wgmma" if M.launches > before[0] else "wmma" if M.launches_wmma > before[1] \
            else None
        if M.path(a, b) != kind or took != kind:
            raise AssertionError(f"matmul {case} took {took}, expected {kind}")
        if not torch.equal(got, M.matmul_plain(a, b)):
            raise AssertionError(f"matmul {case} ({kind}) != plain on integer inputs")
    return len(cases)


def time_matmul(cases: dict) -> dict:
    """Per case: kernel, plain and torch.bmm (the library call) ms, and the
    bound; then their sums over one step's launches, and means per launch."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "device_ms": 0.0,
           "library_device_ms": 0.0, "launches": 0}
    for key, count in cases.items():
        r, m, k, n, a_t, b_t, dtype = key
        a = _operand(r, m, k, a_t, dtype, gen)
        b = _operand(r, k, n, b_t, dtype, gen)
        item = a.element_size()
        row = {"path": M.path(a, b), "ms": _time(lambda: M.matmul(a, b)),
               "plain_ms": _time(lambda: M.matmul_plain(a, b)),
               "library_ms": _time(lambda: torch.bmm(a, b)),
               "bound_ms": max(2 * r * m * n * k / FLOPS[dtype],
                               r * (m * k + k * n + m * n) * item / HBM_BYTES_PER_S) * 1e3}
        row.update({"host_ms": _host_ms(lambda: M.matmul(a, b)),
                    "device_ms": _device_ms(lambda: M.matmul(a, b)),
                    "library_device_ms": _device_ms(lambda: torch.bmm(a, b))})
        row["device_tflops"] = 2 * r * m * n * k / row["device_ms"] / 1e9
        row["library_device_tflops"] = 2 * r * m * n * k / row["library_device_ms"] / 1e9
        print(f"[matmul] R={r} M={m} K={k} N={n} a^T={a_t} b^T={b_t} {str(dtype)[6:]} "
              f"x{count} per step " + json.dumps(row), flush=True)
        for name in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                     "library_device_ms"):
            tot[name] += row[name] * count
        tot["launches"] += count
    per = {f"{name}_per_launch": tot[name] / tot["launches"]
           for name in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**tot, **per}


# ---------------------------------------------------------------- training


def _train_run(cfg, shape, mode: str, *, prefetch: bool = False,
               remat: str = "full") -> RunConfig:
    return RunConfig(model=cfg, shape=shape, train=TrainConfig(remat=remat),
                     collective=CollectiveConfig(fsdp_mode=mode, n_chains=N_CHAINS,
                                                 prefetch=prefetch))


def _train_launches(cfg, mesh: StackedMesh, mode: str, *, prefetch: bool = False,
                    remat: str = "full") -> dict[str, int]:
    """Kernel launches and schedule entries a train step makes at full
    width: a gather per sharded leaf and layer in the forward, again in each
    checkpointed body's recompute (L bodies; with prefetch L - 1, each
    gathering the next layer: layer 0's gather and the last block are
    outside them); a transpose per forward gather; the matmuls of
    ``matmul_cases`` (remat="full": every projection's forward twice), less
    the forwards of the layers that no "full" body recomputes ("dots" keeps
    every product, "none" and the last block under prefetch recompute
    none)."""
    leaves, layers = len(_layer_leaves(cfg)), cfg.num_layers
    bodies = 0 if remat == "none" else layers - 1 if prefetch else layers
    gathers = 0 if mode == "xla" else leaves * (layers + bodies)
    transposes = 0 if mode == "xla" else leaves * layers
    matmul = sum(matmul_cases(cfg, mesh.n_ranks, TRAIN_SHAPE.global_batch // mesh.n_ranks
                              * TRAIN_SHAPE.seq_len, torch.bfloat16, train=True).values())
    matmul -= leaves * (layers - (bodies if remat == "full" else 0))
    p = mesh.n_ranks
    return {**{k: 0 for k in PACKET_KERNELS + LAYER_KERNELS + OFF_PATH},
            "ring_allgather": gathers,
            **_want_entries(mode, gathers * (p - 1), p),
            "ring_step": 0, "ring_allgather_transpose": transposes,
            **_want_entries(mode, transposes * (p - 1), p, "transpose_entries"),
            "matmul": matmul}


def check_train_reference() -> float:
    """Reduced smollm-135m in f32: the train step sharded over 8 ranks
    (mcast, then mcast_bcast) against a single-rank run of the same step, 3
    steps. Returns the largest relative loss difference."""
    cfg = reduced(get_model_config("smollm-135m"))
    shape = ShapeConfig("t", "train", 64, 8)
    tree = bridge.random_params(cfg, seed=1)
    batches = [SyntheticPipeline(cfg, shape).next_batch(i) for i in range(3)]
    out = {}
    for mode, mesh in (("mcast", None), ("mcast", StackedMesh(data=8, model=1)),
                       ("mcast_bcast", StackedMesh(data=8, model=1))):
        run = _train_run(cfg, shape, mode)
        _, _, step = make_train_step(run, mesh)
        state = init_state(run, mesh, tree)
        rows = []
        for b in batches:
            state, m = step(state, b)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[mode, mesh is None] = rows
    worst = 0.0
    for key in (("mcast", False), ("mcast_bcast", False)):
        for (loss, gn), (l1, g1) in zip(out[key], out["mcast", True]):
            worst = max(worst, abs(loss - l1) / abs(l1))
            if not (abs(loss - l1) <= 1e-5 * abs(l1) and abs(gn - g1) <= 1e-4 * abs(g1)):
                raise AssertionError(f"{key[0]} sharded vs single-rank train step: loss "
                                     f"{loss} vs {l1}, grad_norm {gn} vs {g1}")
    print(f"[reference] reduced f32 train step, 8 ranks vs 1: {json.dumps(out[('mcast', False)])}"
          f" vs {json.dumps(out[('mcast', True)])}", flush=True)
    return worst


def train() -> tuple[dict[str, int], dict[str, tuple[list, list]]]:
    """Phase 4: the training path at full width in every mode. Returns the
    launches per step of each kernel in the mcast mode, and each mode's
    losses and grad norms (the warm-up step's, then the timed steps')."""
    cfg = get_model_config("smollm-135m")
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, seed=0)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    batches = [pipe.next_batch(i) for i in range(TRAIN_TIMED + 2)]
    first_loss, per_step, metrics = {}, {}, {}
    for mode in MODES:
        want = _train_launches(cfg, mesh, mode)
        row, counts = _train_steps(cfg, mesh, tree, batches, mode, TRAIN_TIMED, want)
        print("[train] " + json.dumps(row), flush=True)
        first_loss[mode] = row["losses"][0]
        per_step[mode] = counts
        metrics[mode] = (row["losses"], row["grad_norms"])
    if len({first_loss[mode] for mode in MODES}) != 1:
        raise AssertionError(f"first-step losses differ between modes: {first_loss}")
    print(f"[train] first-step loss bitwise equal in every mode: {first_loss['xla']!r}",
          flush=True)
    return per_step["mcast"], metrics


def _train_steps(cfg, mesh: StackedMesh, tree, batches: list, mode: str, timed: int,
                 want: dict[str, int]) -> tuple[dict, dict[str, int]]:
    """A warm-up step on ``batches[0]``, ``timed`` steps on the next batches,
    each launching exactly ``want``, and a profiled step on
    ``batches[timed + 1]``, of ``mode``. Returns the row of figures and the
    last step's launches."""
    run = _train_run(cfg, TRAIN_SHAPE, mode)
    _, _, step = make_train_step(run, mesh)
    state = init_state(run, mesh, tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])   # warm-up
    losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
    warm_s = time.perf_counter() - t0
    samples = []
    for b in batches[1:timed + 1]:
        (state, m), dt, counts = _run(lambda b=b: step(state, b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        samples.append(dt)
        if counts != want:
            raise AssertionError(f"{mode}: launches per train step {counts}, expected {want}")
    row = {"mode": mode, "losses": losses, "grad_norms": norms, "warmup_step_ms": warm_s * 1e3,
           **_step_times(samples), "launches_per_step": counts,
           **_profiled_step(step, state, batches[timed + 1], f"{mode} step")}
    _check_losses(cfg, mode, losses, norms)
    del state, m
    torch.cuda.empty_cache()
    return row, counts


def _step_times(samples: list[float]) -> dict:
    return {"step_ms_median": statistics.median(samples) * 1e3,
            "step_ms_samples": [t * 1e3 for t in samples],
            "tokens_per_s": TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len
            / statistics.median(samples)}


def _check_losses(cfg, what: str, losses: list[float], norms: list[float]) -> None:
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"{what}: non-finite loss or grad norm {losses} {norms}")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"{what}: first loss {losses[0]} far from ln V at random init")


def _profiled_step(step, state, batch, what: str) -> dict:
    """One train step under the profiler: the device's busy ms (the sum of
    its records, and their union, which counts two streams' overlapping
    work once), its idle share, the device ms of the matmuls, gathers and
    transposes, the streams the gathers, transposes and matmuls ran on, and
    the device ms of gathers and of transposes that ran while a record of
    another stream ran."""
    holder = {"state": state}

    def profiled():
        holder["state"], _ = step(holder["state"], batch)

    dev, prof_ms, records = _profiled(profiled)
    busy = sum(dev.values())
    gathers = _overlap(records, ("ring_allgather_kernel",))
    transposes = _overlap(records, ("ring_allgather_transpose_kernel",))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    print(f"[train] {what}, top device time (ms): "
          + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return {"device_busy_ms": busy, "profiled_wall_ms": prof_ms,
            "device_idle_share": 1 - busy / prof_ms,
            "device_busy_union_ms": gathers["busy_ms"],
            "device_idle_share_union": 1 - gathers["busy_ms"] / prof_ms,
            "matmul_device_ms": sum(t for k, t in dev.items() if "matmul_" in k),
            "ring_allgather_device_ms": sum(t for k, t in dev.items()
                                            if "ring_allgather_kernel" in k),
            "ring_allgather_transpose_device_ms": sum(
                t for k, t in dev.items() if "ring_allgather_transpose_kernel" in k),
            "streams": gathers["all_streams"], "gather_streams": gathers["streams"],
            "transpose_streams": transposes["streams"],
            "matmul_streams": _overlap(records, ("matmul_",))["streams"],
            "gather_overlap_ms": gathers["overlap_ms"],
            "transpose_overlap_ms": transposes["overlap_ms"]}


# phase 4b: the training path's options, (mode, prefetch, remat); the first
# is phase 4's mcast step, the yardstick whose steps alternate with theirs
TRAIN_OPTIONS = (("mcast", False, "full"), ("mcast", True, "full"), ("mcast", False, "dots"),
                 ("mcast", True, "dots"), ("mcast_bcast", True, "full"))
OPTIONS_ROUNDS = 3


def train_options(base: dict[str, tuple[list, list]]) -> None:
    """Phase 4b: training at full width with ``CollectiveConfig.prefetch``
    and ``remat="dots"``, alone and together (``TRAIN_OPTIONS``), beside
    phase 4's mcast step. Each variant: a warm-up step, its peak memory
    above what was resident before its state was made; then
    ``OPTIONS_ROUNDS`` rounds of one timed step of every variant, the order
    reversed each round, each step launching what ``_train_launches``
    counts; then a profiled step (``_profiled_step``). The first-step loss
    must be phase 4's bitwise (``base``: its losses and grad norms by
    mode), the grad norms within 1e-4 relative of phase 4's over the same
    steps; under prefetch the profiler must show the gathers on a stream
    that no matmul runs on."""
    cfg = get_model_config("smollm-135m")
    mesh = StackedMesh(data=8, model=1)
    tree = bridge.random_params(cfg, seed=0)
    pipe = SyntheticPipeline(cfg, TRAIN_SHAPE)
    batches = [pipe.next_batch(i) for i in range(OPTIONS_ROUNDS + 2)]
    runs = {}
    for mode, prefetch, remat in TRAIN_OPTIONS:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = _train_run(cfg, TRAIN_SHAPE, mode, prefetch=prefetch, remat=remat)
        _, _, step = make_train_step(run, mesh)
        state = init_state(run, mesh, tree)
        t0 = time.perf_counter()
        state, m = step(state, batches[0])   # warm-up
        losses, norms = [float(m["loss"])], [float(m["grad_norm"])]
        torch.cuda.synchronize()
        runs[mode, prefetch, remat] = {
            "step": step, "state": state, "losses": losses, "norms": norms, "samples": [],
            "want": _train_launches(cfg, mesh, mode, prefetch=prefetch, remat=remat),
            "row": {"mode": mode, "prefetch": prefetch, "remat": remat,
                    "warmup_step_ms": (time.perf_counter() - t0) * 1e3,
                    "peak_memory_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30}}
    for r in range(OPTIONS_ROUNDS):
        for key in (TRAIN_OPTIONS if r % 2 == 0 else TRAIN_OPTIONS[::-1]):
            v = runs[key]
            (v["state"], m), dt, counts = _run(lambda: v["step"](v["state"], batches[r + 1]))
            v["losses"].append(float(m["loss"]))
            v["norms"].append(float(m["grad_norm"]))
            v["samples"].append(dt)
            if counts != v["want"]:
                raise AssertionError(f"{key}: launches per train step {counts}, expected "
                                     f"{v['want']}")
    for key, v in runs.items():
        mode, prefetch, remat = key
        row = {**v["row"], "losses": v["losses"], "grad_norms": v["norms"],
               **_step_times(v["samples"]), "launches_per_step": v["want"],
               **_profiled_step(v["step"], v["state"], batches[OPTIONS_ROUNDS + 1],
                                f"{mode} prefetch={prefetch} remat={remat} step")}
        _check_losses(cfg, str(key), v["losses"], v["norms"])
        losses, norms = base[mode]
        if v["losses"][0] != losses[0]:
            raise AssertionError(f"{key}: first-step loss {v['losses'][0]!r} is not phase 4's "
                                 f"{losses[0]!r}")
        for got, ref in zip(v["norms"], norms):
            if abs(got - ref) > 1e-4 * abs(ref):
                raise AssertionError(f"{key}: grad norms {v['norms']} vs phase 4's {norms}")
        if prefetch and (not row["gather_streams"]
                         or set(row["gather_streams"]) & set(row["matmul_streams"])):
            raise AssertionError(f"{key}: the profiler shows the gathers on streams "
                                 f"{row['gather_streams']}, the matmuls on "
                                 f"{row['matmul_streams']}")
        print("[train-options] " + json.dumps(row), flush=True)


# ------------------------------------------------------- packet broadcast

# name: (hosts, bytes, WorkerParams, loss per leaf, seed); FabricParams() for
# both (MTU 4096, 1 us jitter), aggregated NACKs
BCASTS = {"A": (512, 64 << 20, dict(n_recv_workers=8), 1e-3, 0),
          "B": (64, 64 << 20, dict(), ("ge", 0.01, 8.0), 4)}


def _bcast(name: str, device: str) -> PK.PacketBcastResult:
    p, n_bytes, wk, loss, seed = BCASTS[name]
    if isinstance(loss, tuple):
        loss = PK.GilbertElliottLoss.from_rate(loss[1], mean_burst=loss[2])
    return PK.simulate_packet_broadcast(p, n_bytes, E.FabricParams(), E.WorkerParams(**wk),
                                        np.random.default_rng(seed), loss=loss,
                                        collect_delivery=True, device=device)


def _assert_same(a: PK.PacketBcastResult, b: PK.PacketBcastResult, what: str) -> None:
    """Every field of two results, exactly."""
    if not np.array_equal(a.completion, b.completion):
        raise AssertionError(f"{what}: completion times differ")
    for name in ("phases", "delivered_fast", "recovered", "rnr_drops", "bytes_fast",
                 "bytes_recovery", "bytes_total", "link_bytes", "rounds",
                 "retransmit_wire_bytes", "duplicates", "completed"):
        if getattr(a, name) != getattr(b, name):
            raise AssertionError(f"{what}: {name} {getattr(a, name)} != {getattr(b, name)}")
    if sorted(a.delivery_order) != sorted(b.delivery_order) or not all(
            np.array_equal(a.delivery_order[k], b.delivery_order[k]) for k in a.delivery_order):
        raise AssertionError(f"{what}: delivery orders differ")


def _exact(name: str, got, want, case) -> float:
    """Raise unless every tensor of ``got`` equals ``want``; the max abs
    difference (0.0 when equal) for the kernels line."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.uint32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        same = g == w
        if not bool(same.all()):
            diff = (g.double() - w.double()).abs()
            err = max(err, float(diff[~same].max()))
            raise AssertionError(f"{name} != plain at {case}: max abs err {err}")
    return err


def _flag_forms(flags: torch.Tensor, gen: torch.Generator) -> list[torch.Tensor]:
    """One flag pattern in every form the pack takes: bool; uint8 of 2 to
    255 where set; int32 of -1 or 1 << 31 where set; uint8 and int32 views
    whose base lies 1, 4 and 8 bytes (uint8) or 4 bytes (int32) off 16,
    which the C entry sends to its warp-per-word kernel."""
    big = torch.randint(2, 256, flags.shape, generator=gen, device="cuda", dtype=torch.uint8)
    sign = torch.randint(0, 2, flags.shape, generator=gen, device="cuda", dtype=torch.int32)
    forms = [flags, torch.where(flags, big, 0),
             torch.where(flags, torch.where(sign == 1, -1, -(1 << 31)), 0).to(torch.int32)]
    for f, offsets in ((forms[1], (1, 4, 8)), (forms[2], (1,))):
        for off in offsets:
            base = torch.empty(f.numel() + off, dtype=f.dtype, device="cuda")
            view = base[off:].view(f.shape)
            view.copy_(f)
            forms.append(view)
    return forms


def _or_rows_inputs(rows: int, n_words: int, gen: torch.Generator):
    """(pattern, int32 words (rows, n_words)) for the OR check: all zero,
    all ones, bit 31 of the last row's last word alone, sparse random words
    (a row's word kept with chance 2 / rows), and those random words as a
    view whose base lies 4 bytes off 16 (the C entry's single-word path)."""
    zero = torch.zeros((rows, n_words), dtype=torch.int32, device="cuda")
    last = zero.clone()
    if rows:
        last[-1, -1] = -(1 << 31)
    rand = torch.randint(-(1 << 31), 1 << 31, (rows, n_words), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)
    rand *= torch.rand((rows, n_words), generator=gen, device="cuda") < 2 / max(rows, 1)
    base = torch.empty(rows * n_words + 1, dtype=torch.int32, device="cuda")
    off = base[1:].view(rows, n_words)
    off.copy_(rand)
    return (("zero", zero), ("ones", torch.full_like(zero, -1)), ("last bit", last),
            ("random", rand), ("off 16 bytes", off))


def check_rx_kernels() -> dict[str, tuple[int, float]]:
    """Phase 1: the receive datapath's kernels vs their plain versions,
    exactly. Returns {kernel: (cases, max abs err)}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out: dict[str, list] = {k: [0, 0.0] for k in PACKET_KERNELS}

    def record(name, got, want, case):
        torch.cuda.synchronize()
        out[name][1] = max(out[name][1], _exact(name, got, want, case))
        out[name][0] += 1

    for w in POOL_WORKERS:
        edge = PL.tile_plan(w)[2]   # a tile of the kernel's plan
        for rows in (1, 7, 63, 511):
            for n in sorted({1, 31, w - 1, w + 1, 4096, 16384, 16389, edge - 1, edge + 1} - {0}):
                a = torch.rand((rows, n), generator=gen, device="cuda", dtype=torch.float64)
                a = torch.sort(torch.round(a * 40) / 4, dim=1).values   # tied arrivals
                if rows > 1:
                    a[rows // 2, n // 3:] = float("inf")                # a ragged row
                for staging in (0, 3, 8192, n + 5):
                    record("pool", PL.pool_completion_rows(a, w, 0.3, staging),
                           PL.pool_completion_rows_plain(a, w, 0.3, staging),
                           (rows, n, w, staging))
                record("pool", (PL.pool_scan_rows(a, w, 0.3),),
                       (PL.pool_scan_rows_plain(a, w, 0.3),), (rows, n, w, None))
    for shape in ((32,), (16384,), (1, 16416), (7, 4096), (1, 1 << 20), (16, 1 << 20),
                  (511, 16384), (512, 16416)):
        for density in (0.3, 1e-3):
            flags = torch.rand(shape, generator=gen, device="cuda") < density
            for f in _flag_forms(flags, gen):
                record("bitmap_pack", (BM.bitmap_pack(f),), (BM.bitmap_pack_plain(f),),
                       (shape, density, f.dtype, f.storage_offset()))
            if len(shape) == 1:
                continue
            words = BM.bitmap_pack(flags)
            record("bitmap_or_rows", (BM.bitmap_or_rows(words),),
                   (BM.bitmap_or_rows_plain(words),), shape)
            record("bitmap_popcount", (BM.bitmap_popcount_rows(words), BM.bitmap_popcount(words)),
                   (BM.bitmap_popcount_rows_plain(words), BM.bitmap_popcount_plain(words)),
                   shape)
    for rows in OR_ROWS:
        for n_words in OR_WORDS:
            for case, w in _or_rows_inputs(rows, n_words, gen):
                words = w.view(torch.uint32)
                record("bitmap_or_rows", (BM.bitmap_or_rows(words),),
                       (BM.bitmap_or_rows_plain(words),), (rows, n_words, case))
    # popcount rows on both sides of the one-strip limit (and empty rows),
    # with no bit, one bit and random bits set
    one = POPCOUNT_STRIP_WORDS
    for rows, n_words in ((1, one), (1, one + 1), (3, one), (2, one + 1), (1, 1), (2, 0)):
        zero = torch.zeros((rows, n_words), dtype=torch.int32, device="cuda")
        single = zero.clone()
        if n_words:
            single[:, n_words // 2] = -(1 << 31)   # bit 31 alone
        rand = torch.randint(-(1 << 31), 1 << 31, (rows, n_words), generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)
        for case, w in (("none", zero), ("one", single), ("random", rand)):
            words = w.view(torch.uint32)
            record("bitmap_popcount", (BM.bitmap_popcount_rows(words), BM.bitmap_popcount(words)),
                   (BM.bitmap_popcount_rows_plain(words), BM.bitmap_popcount_plain(words)),
                   (rows, n_words, case))
    for dtype in (torch.uint8, torch.bfloat16, torch.float32, torch.int32):
        for chunk in (4096 // torch.empty((), dtype=dtype).element_size(), 1023):
            for n_staged, n_chunks, n_valid, dups in ((20, 32, 15, True), (300, 100, 250, True),
                                                      (10, 16, 0, True), (64, 64, 64, False)):
                staging = (torch.rand((n_staged, chunk), generator=gen, device="cuda")
                           * 100).to(dtype)
                psn = (torch.randint(0, n_chunks, (n_staged,), generator=gen, device="cuda")
                       if dups else torch.randperm(n_chunks, generator=gen, device="cuda"))
                user = (torch.rand((n_chunks, chunk), generator=gen, device="cuda")
                        * 100).to(dtype)
                for p in (psn, psn.to(torch.int32)):   # both PSN types, read in place
                    record("chunk_reassembly",
                           CR.chunk_reassembly(staging, p, user.clone(), n_valid),
                           CR.chunk_reassembly_plain(staging, p, user.clone(), n_valid),
                           (dtype, chunk, n_staged, n_chunks, n_valid, p.dtype))
    return {k: (c, e) for k, (c, e) in out.items()}


def check_no_sync() -> int:
    """The reassembly and popcount wrappers under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that synchronises
    with the host raises. Both PSN types; popcount rows of one strip and of
    several. Returns the calls made; each result equals its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    staging = torch.randint(0, 256, (300, 4096), generator=gen, device="cuda", dtype=torch.uint8)
    psn = torch.randint(0, 100, (300,), generator=gen, device="cuda")
    user = torch.zeros((100, 4096), device="cuda", dtype=torch.uint8)
    words = [torch.randint(-(1 << 31), 1 << 31, (2, n), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32).view(torch.uint32)
             for n in (512, POPCOUNT_STRIP_WORDS + 1)]
    calls = [lambda p=p: CR.chunk_reassembly(staging, p, user.clone(), 250)
             for p in (psn, psn.to(torch.int32))]
    calls += [f for w in words for f in (lambda w=w: (BM.bitmap_popcount(w),),
                                         lambda w=w: (BM.bitmap_popcount_rows(w),))]
    for call in calls:   # warm-up: libraries loaded, allocator's blocks cached
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [call() for call in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [CR.chunk_reassembly_plain(staging, p, user.clone(), 250)
            for p in (psn, psn.to(torch.int32))]
    want += [f for w in words for f in ((BM.bitmap_popcount_plain(w),),
                                        (BM.bitmap_popcount_rows_plain(w),))]
    for k, (g, w) in enumerate(zip(got, want)):
        _exact("no-sync call", g, w, k)
    return len(calls)


def replay(res: PK.PacketBcastResult, n_bytes: int) -> int:
    """Every leaf's receive datapath replayed in its delivery order into a
    zeroed buffer: it must rebuild the root's buffer, its bitmap full."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    src = protocol.segment(torch.randint(0, 256, (n_bytes,), generator=gen, device="cuda",
                                         dtype=torch.uint8))
    for leaf in res.delivery_order:
        user, flags = protocol.reassemble(res, src, leaf)
        got = int(BM.bitmap_popcount(BM.bitmap_pack(flags)))
        if got != src.shape[0] or not torch.equal(user, src):
            raise AssertionError(f"leaf {leaf}: replay rebuilt {got} of {src.shape[0]} chunks, "
                                 f"buffer equal: {torch.equal(user, src)}")
    return len(res.delivery_order)


def packet_path() -> tuple[dict[str, int], dict[str, PK.PacketBcastResult]]:
    """Phase 5: broadcasts A and B on the card against their CPU runs, and
    the delivery replay. Returns the path's launches and the card results."""
    cpu, cpu_wall = {}, {}
    for name in BCASTS:
        cpu[name] = _bcast(name, "cpu")   # also the warm-up of its timing
        cpu_wall[name] = _wall(lambda name=name: _bcast(name, "cpu"))
    _zero_counts()   # counts from here to the read are the packet path's
    card = {name: _bcast(name, "cuda") for name in BCASTS}
    leaves = replay(card["A"], BCASTS["A"][1])
    torch.cuda.synchronize()
    counts = _counts()
    for name in PACKET_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the packet path: {counts}")
    calls = rx_shapes(card)
    for name in calls:   # the shapes timed later are every call's
        if counts[name] != len(calls[name]):
            raise AssertionError(f"{name}: {counts[name]} launches on the packet path, "
                                 f"{len(calls[name])} calls in its round traces")
    for name in BCASTS:
        _assert_same(card[name], cpu[name], f"broadcast {name}, card vs CPU")
    print(f"[packet] A and B on the card equal their CPU runs field for field; all {leaves} "
          f"leaves of A rebuilt the root's buffer by reassembly", flush=True)
    dev, prof_ms = _device_times(lambda: replay(card["A"], BCASTS["A"][1]))
    print("[packet] replay of A, device ms of the whole replay: "
          + json.dumps({"reassembly_winner_kernel": sum(t for k, t in dev.items()
                                                        if "winner_kernel" in k),
                        "reassembly_scatter_kernel": sum(t for k, t in dev.items()
                                                         if "scatter_" in k),
                        "memset": sum(t for k, t in dev.items() if "emset" in k),
                        "popcount": sum(t for k, t in dev.items() if "popcount" in k),
                        "busy_ms": sum(dev.values()), "profiled_wall_ms": prof_ms,
                        "leaves": leaves}), flush=True)
    for name in BCASTS:
        def call(name=name):
            return _bcast(name, "cuda")

        _, _, per_call = _run(call)
        wall = _wall(call)
        dev, prof_ms = _device_times(call)
        busy = sum(dev.values())
        res = card[name]
        p, n_bytes, wk, loss, seed = BCASTS[name]
        row = {"broadcast": name, "hosts": p, "bytes": n_bytes, "workers": wk, "loss": loss,
               "seed": seed, "rounds": [dataclasses.astuple(r) for r in res.rounds],
               "time_s": res.time, "rnr_drops": res.rnr_drops, "recovered": res.recovered,
               "duplicates": res.duplicates, "completed": res.completed,
               "wall_ms_median": statistics.median(wall) * 1e3,
               "wall_ms_samples": [t * 1e3 for t in wall],
               "device_busy_ms": busy, "profiled_wall_ms": prof_ms,
               "device_idle_share": 1 - busy / prof_ms,
               "launches_per_call": {k: per_call[k] for k in PACKET_KERNELS},
               "kernel_device_ms": {k: sum(t for key, t in dev.items() if k in key)
                                    for k in ("pool_rows_kernel", "pack_kernel",
                                              "or_rows_kernel", "popcount_row")},
               "cpu_wall_ms_median": statistics.median(cpu_wall[name]) * 1e3,
               "cpu_wall_ms_samples": [t * 1e3 for t in cpu_wall[name]]}
        print("[packet] " + json.dumps(row), flush=True)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
        print(f"[packet] {name}, top device time (ms): "
              + json.dumps({k[:60]: t for k, t in top}), flush=True)
    return counts, card


def rx_shapes(card: dict[str, PK.PacketBcastResult]) -> dict[str, list]:
    """Every call the packet path makes of the pool scan, the pack and the
    OR, from the broadcasts' round traces: the fast path's pool call over
    all leaves and, each round, a pool call over its NACKing leaves'
    retransmitted chunks, a pack of their flags and the OR of the packed
    rows; then one single-row pack per leaf in A's replay. {"pool": [((rows,
    n), W, staging), ...], "bitmap_pack": [shape, ...], "bitmap_or_rows":
    [(rows, words), ...]}, a call an entry, in the run's order."""
    fab = E.FabricParams()
    out: dict[str, list] = {"pool": [], "bitmap_pack": [], "bitmap_or_rows": []}
    for name, res in card.items():
        p, n_bytes, wk, _, _ = BCASTS[name]
        workers, n = E.WorkerParams(**wk), n_bytes // fab.mtu
        ring = (workers.n_recv_workers, workers.staging_chunks)
        out["pool"].append(((p - 1, n), *ring))
        for r in res.rounds:
            out["pool"].append(((r.nack_leaves, r.union_chunks), *ring))
            out["bitmap_pack"].append((r.nack_leaves, n))
            out["bitmap_or_rows"].append((r.nack_leaves, -(-n // 32)))
    out["bitmap_pack"] += [(BCASTS["A"][1] // fab.mtu,)] * len(card["A"].delivery_order)
    return out


def time_rx_shapes(calls: dict[str, list], service: float) -> dict[str, list[dict]]:
    """The pool scan, the pack and the OR at each distinct shape of
    ``calls`` (``rx_shapes``; a kernel missing from ``calls`` is skipped),
    in order of first call: ms a call from Python (``_time``), host issue
    (``_host_ms``), device ms (``_device_ms``), the plain version's ms, the
    bound (bytes over 3.35 TB/s: 8 B in and 17 B in all an element for the
    pool; each flag byte in and 4 B a word out for the pack; 4 B a word in
    and 4 B an output word out for the OR), the calls at that shape, and a
    yardstick the port never calls: for the pool the device ms of
    ``torch.cummax`` over the +inf-padded (R, ceil(n / W), W) view, the
    scan alone and not the function; for the pack and the OR the device ms
    of one ``copy_`` of their input bytes. Arrivals are sorted uniform rows,
    flags set at 1e-3 (the OR's words are such flags packed), all from a
    seed."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out: dict[str, list[dict]] = {name: [] for name in calls}
    for (rows, n), w, staging in dict.fromkeys(calls.get("pool", ())):
        a = torch.sort(torch.rand((rows, n), generator=gen, device="cuda", dtype=torch.float64)
                       * (n * service), dim=1).values
        pad = (-n) % w
        view = F.pad(a, (0, pad), value=float("inf")).view(rows, (n + pad) // w, w)
        row = {"shape": [rows, n], "workers": w, "staging": staging,
               "calls": calls["pool"].count(((rows, n), w, staging)),
               **_kernel_times(lambda: PL.pool_completion_rows(a, w, service, staging),
                               lambda: PL.pool_completion_rows_plain(a, w, service, staging),
                               rows * n * 17),
               "cummax_scan_alone_device_ms": _device_ms(lambda: torch.cummax(view, 1))}
        print("[pool] " + json.dumps(row), flush=True)
        out["pool"].append(row)
    for shape in dict.fromkeys(calls.get("bitmap_pack", ())):
        flags = torch.rand(shape, generator=gen, device="cuda") < 1e-3
        copy = torch.empty_like(flags)
        row = {"shape": list(shape), "dtype": "bool", "calls": calls["bitmap_pack"].count(shape),
               **_kernel_times(lambda: BM.bitmap_pack(flags), lambda: BM.bitmap_pack_plain(flags),
                               flags.numel() + flags.numel() // 32 * 4),
               "copy_device_ms": _device_ms(lambda: copy.copy_(flags))}
        print("[bitmap_pack] " + json.dumps(row), flush=True)
        out["bitmap_pack"].append(row)
    for rows, n_words in dict.fromkeys(calls.get("bitmap_or_rows", ())):
        words = BM.bitmap_pack(torch.rand((rows, 32 * n_words), generator=gen,
                                          device="cuda") < 1e-3)
        copy = torch.empty_like(words)
        row = {"shape": [rows, n_words], "calls": calls["bitmap_or_rows"].count((rows, n_words)),
               **_kernel_times(lambda: BM.bitmap_or_rows(words),
                               lambda: BM.bitmap_or_rows_plain(words), (rows + 1) * n_words * 4),
               "copy_device_ms": _device_ms(lambda: copy.copy_(words))}
        print("[bitmap_or_rows] " + json.dumps(row), flush=True)
        out["bitmap_or_rows"].append(row)
    return out


def _kernel_times(kernel, plain, nbytes: int) -> dict[str, float]:
    return {"ms": _time(kernel), "host_ms": _host_ms(kernel), "device_ms": _device_ms(kernel),
            "plain_ms": _time(plain), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def time_rx_kernels(card: dict[str, PK.PacketBcastResult]) -> dict[str, dict]:
    """Each receive-datapath kernel at the shape broadcast A gives it: ms
    per call from Python (CUDA events around back-to-back calls, ``_time``)
    of the kernel, its plain version and (for reassembly) one library call,
    ``index_copy_``; the kernel's host issue per call (``_host_ms``) and
    device ms per call (``_device_ms``; a reassembly call is a zero fill and
    two launches); beside the bound: bytes (each input read once, each
    output written once) over 3.35 TB/s, and for reassembly the device ms of
    a plain copy of the same rows (``copy_``, one cudaMemcpyAsync). The pool
    scan, the pack and the OR are timed at every shape the run gives them
    (``time_rx_shapes``); their rows here are A's first call of each."""
    res_a = card["A"]
    p, n_bytes, wk, _, _ = BCASTS["A"]
    fab, workers = E.FabricParams(), E.WorkerParams(**wk)
    n, chunk = n_bytes // fab.mtu, fab.mtu
    service = chunk / workers.thread_tput
    nackers = res_a.rounds[0].nack_leaves
    shaped = time_rx_shapes(rx_shapes(card), service)
    gen = torch.Generator(device="cuda").manual_seed(7)
    flags = torch.rand((nackers, n), generator=gen, device="cuda") < 1e-3
    agg = BM.bitmap_or_rows(BM.bitmap_pack(flags))
    src = torch.randint(0, 256, (n, chunk), generator=gen, device="cuda", dtype=torch.uint8)
    psn = torch.randperm(n, generator=gen, device="cuda")
    staging, user = src[psn], torch.zeros_like(src)
    w = n // 32
    cases = {
        "bitmap_popcount": ((w,), w * 4 + 8,
                            lambda: BM.bitmap_popcount(agg),
                            lambda: BM.bitmap_popcount_plain(agg), None),
        "chunk_reassembly": ((n, chunk), 2 * n * chunk + n * (psn.element_size() + 4),
                             lambda: CR.chunk_reassembly(staging, psn, user),
                             lambda: CR.chunk_reassembly_plain(staging, psn, user),
                             lambda: user.index_copy_(0, psn, staging)),
    }
    out = {name: {**rows[0], "library_ms": None} for name, rows in shaped.items()}
    for name, (shape, nbytes, kernel, plain, library) in cases.items():
        row = {"shape": shape, **_kernel_times(kernel, plain, nbytes),
               "library_ms": _time(library) if library else None}
        if name == "chunk_reassembly":   # the same bytes as one cudaMemcpyAsync
            row["memcpy_device_ms"] = _device_ms(lambda: user.copy_(staging))
        print(f"[{name}] " + json.dumps(row), flush=True)
        out[name] = row
    return out


# ------------------------------------------------------- the collective layer

AGMM_ROWS = (BATCH * PROMPT // 8, TRAIN_SHAPE.global_batch * TRAIN_SHAPE.seq_len // 8)
AGMM_WIDTHS = ((576, 576), (576, 192), (576, 1536), (1536, 576))   # the block's projections
# matmul_pallas refuses K or N = 576 or 192 at its default 128 tiles (its
# precondition, which the port keeps); 64 divides every width
AGMM_TILES = dict(bk=64, bn=64)


def _host_ms(fn, repeats: int = REPEATS) -> float:
    """Median host ms to issue one call of ``fn`` (after a synchronise; no
    synchronise after it): the launch overhead alone."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def _device_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: n calls queued behind a spin kernel, so
    that the CUDA events around them time device work alone, not the host's
    issue (the calls end with the current stream waiting for any side
    stream, so both streams are inside the events). The spin is lengthened
    until it outlasts the host's issue of the n calls."""
    fn()
    spin_ms = 2 * n * _host_ms(fn) + 1.0
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(int(spin_ms * 1.5e6))     # cycles at >= 1.5 GHz
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if marks[0].elapsed_time(marks[1]) > issue_ms:
            return marks[1].elapsed_time(marks[2]) / n
        spin_ms *= 2


def check_drain() -> tuple[int, float]:
    """Phase 6a: the drain kernel vs its plain version, exactly."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [torch.randn((8, rows, 576), generator=gen, device="cuda").bfloat16()
             for rows in AGMM_ROWS]
    cases += [torch.randn(shape, generator=gen, device="cuda") for shape in ((6, 8, 128),
                                                                             (3, 16, 64))]
    cases += [torch.randint(0, 256, (5, 7, 33), generator=gen, device="cuda").to(torch.uint8),
              torch.randint(-99, 99, (3, 17, 5), generator=gen, device="cuda").int(),
              torch.randint(0, 256, (1 + 4 * 300 * 77,), generator=gen, device="cuda")
              .to(torch.uint8)[1:].view(4, 300, 77),
              torch.randn((1 + 2 * 64 * 513,), generator=gen, device="cuda")
              .bfloat16()[1:].view(2, 64, 513)]
    for staged in cases:
        got = K.local_double_buffer_drain(staged)
        torch.cuda.synchronize()
        _exact("double_buffer_drain", (got,), (K.local_double_buffer_drain_plain(staged),),
               (tuple(staged.shape), staged.dtype, staged.data_ptr() % 16))
    return len(cases), 0.0


def _agmm_inputs() -> dict:
    """{(rows, K, N): (x (8, rows, K), w (K, N))}, bf16, w at its init scale."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    return {(rows, k, n): (torch.randn((8, rows, k), generator=gen, device="cuda").bfloat16(),
                           (torch.randn((k, n), generator=gen, device="cuda")
                            / k ** 0.5).bfloat16())
            for rows in AGMM_ROWS for k, n in AGMM_WIDTHS}


def _gathered(x: torch.Tensor) -> torch.Tensor:
    p, m, k = x.shape
    return C.plain_allgather_local(x.reshape(p, m * k)).reshape(p, p * m, k)


def layer_path() -> tuple[dict[str, int], dict]:
    """Phase 6b: the allgather-matmul and the drain through their entry
    points, launch counts zeroed before and read after; then each result
    against gather-then-matmul (bitwise) and the plain product. Returns the
    path's launches and the inputs with their max abs error vs plain."""
    mesh = StackedMesh(data=8, model=1)
    agmm = M.make_allgather_matmul(mesh, "data", **AGMM_TILES)
    agmm_steps = M.make_allgather_matmul(mesh, "data", use_pallas=False, **AGMM_TILES)
    inputs = _agmm_inputs()
    x_rows = {rows: x for (rows, _, _), (x, _) in inputs.items()}
    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are the collective layer's path
    got = {key: agmm(x, w) for key, (x, w) in inputs.items()}
    got_steps = {key: agmm_steps(x, w) for key, (x, w) in inputs.items()}
    drained = {rows: K.local_double_buffer_drain(x) for rows, x in x_rows.items()}
    torch.cuda.synchronize()
    counts = _counts()
    for name in ("allgather_matmul", "matmul", "double_buffer_drain", "ring_step"):
        if counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the collective layer's path: "
                                 f"{counts}")
    # one group per call: one wgmma launch that reads the shards in place;
    # use_pallas=False: the ring schedule's P - 1 steps and plain products
    want = {**{name: 0 for name in counts}, "allgather_matmul": len(inputs),
            "matmul": len(inputs), "double_buffer_drain": len(x_rows),
            "ring_step": 7 * len(inputs)}
    if counts != want:
        raise AssertionError(f"launches {counts} for {len(inputs)} allgather-matmul calls, "
                             f"expected {want}")
    errs = {}
    for key, (x, w) in inputs.items():
        rows = _gathered(x)
        wr = w.expand(8, *w.shape)
        if not torch.equal(got[key], M.matmul(rows, wr)):
            raise AssertionError(f"allgather_matmul {key} != gather then matmul")
        plain = M.matmul_plain(rows, wr)
        err = (got[key].float() - plain.float()).abs().max().item()
        if not err <= 1e-2 * plain.float().abs().max().item():
            raise AssertionError(f"allgather_matmul {key} vs plain: max err {err}")
        errs[key] = err
        err = (got_steps[key].float() - plain.float()).abs().max().item()
        if not err <= 1e-2 * plain.float().abs().max().item():
            raise AssertionError(f"allgather_matmul {key}, use_pallas=False, vs plain: max "
                                 f"err {err}")
    for rows, x in x_rows.items():
        if not torch.equal(drained[rows], x):
            raise AssertionError(f"the drain of the {rows}-row shards differs")
    print(f"[layer] {len(inputs)} allgather-matmul calls equal gather-then-matmul bitwise, "
          f"and as many with use_pallas=False within limits of plain; launches "
          f"{json.dumps(counts)}", flush=True)
    return counts, {"inputs": inputs, "errs": errs}


def time_layer(path: dict) -> dict[str, dict]:
    """Phase 6b's times: per case the call (one launch) and the reference's
    ring schedule on one stream (P - 1 ring steps and 2P - 1 products
    on the matmul kernel): ms per call back to back from CUDA events; the
    median of REPEATS synchronised calls; the host's issue time; the device
    time, and the idle share it leaves of the synchronised call; then the
    plain version (plain gather, then the plain product) and the library
    route (plain gather, then one torch.bmm), beside the bound. Then the
    drain at the shards' shapes (L2-resident, as freshly received shards
    are), timed in turns with ``clone()`` (medians of REPEATS each).
    Returns the kernels-line means. Device times come from
    ``_device_ms``: the profiler drops records on the card's machine."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "flops_ms": 0.0,
           "bytes_ms": 0.0}
    for (m, k, n), (x, w) in path["inputs"].items():
        p = x.shape[0]
        wr = w.expand(p, k, n)
        fns = {"ms": lambda: M.allgather_matmul_local(x, w, **AGMM_TILES),
               "ring_schedule_ms": lambda: M._allgather_matmul(x, w, M.matmul),
               "plain_ms": lambda: M.matmul_plain(_gathered(x), wr),
               "library_ms": lambda: torch.bmm(_gathered(x), wr)}
        row = {name: _time(fn) for name, fn in fns.items()}
        wall, wall1 = _wall(fns["ms"]), _wall(fns["ring_schedule_ms"])
        dev, dev1 = _device_ms(fns["ms"]), _device_ms(fns["ring_schedule_ms"])
        flops = p * (p * m) * k * n * 2
        flops_ms = flops / FLOPS[torch.bfloat16] * 1e3
        bytes_ms = (x.numel() + w.numel() + p * p * m * n) * 2 / HBM_BYTES_PER_S * 1e3
        row.update({"rows_per_rank": m, "K": k, "N": n,
                    "wall_ms_median": statistics.median(wall) * 1e3,
                    "wall_ms_samples": [t * 1e3 for t in wall],
                    "ring_schedule_wall_ms_median": statistics.median(wall1) * 1e3,
                    "host_issue_ms": _host_ms(fns["ms"]),
                    "ring_schedule_host_issue_ms": _host_ms(fns["ring_schedule_ms"]),
                    "device_ms": dev, "ring_schedule_device_ms": dev1,
                    "device_tflops": flops / dev / 1e9,
                    "library_device_ms": _device_ms(fns["library_ms"]),
                    "device_idle_share": 1 - dev / (statistics.median(wall) * 1e3),
                    "ring_schedule_device_idle_share":
                        1 - dev1 / (statistics.median(wall1) * 1e3),
                    "bound_ms": max(flops_ms, bytes_ms),
                    "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                    "max_abs_err_vs_plain": path["errs"][m, k, n]})
        print("[allgather_matmul] " + json.dumps(row), flush=True)
        for name in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[name] += row[name] / len(path["inputs"])
        tot["flops_ms"] += flops_ms
        tot["bytes_ms"] += bytes_ms
    tot["bound_by"] = "operations" if tot["flops_ms"] >= tot["bytes_ms"] else "bytes"
    tot["max_abs_err"] = max(path["errs"].values())
    drain = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for m in AGMM_ROWS:
        x = next(x for (rows, _, _), (x, _) in path["inputs"].items() if rows == m)
        turns = {"ms": [], "library_ms": []}   # the drain and clone() in turns
        for _ in range(REPEATS):
            turns["ms"].append(_time(lambda: K.local_double_buffer_drain(x)))
            turns["library_ms"].append(_time(lambda: x.clone()))
        row = {"shape": tuple(x.shape), "ms": statistics.median(turns["ms"]),
               "ms_samples": turns["ms"],
               "plain_ms": _time(lambda: K.local_double_buffer_drain_plain(x)),
               "library_ms": statistics.median(turns["library_ms"]),
               "library_ms_samples": turns["library_ms"],
               "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3,
               "device_ms": _device_ms(lambda: K.local_double_buffer_drain(x)),
               "library_device_ms": _device_ms(lambda: x.clone())}
        print("[double_buffer_drain] " + json.dumps(row), flush=True)
        for name in drain:
            drain[name] += row[name] / len(AGMM_ROWS)
    return {"allgather_matmul": tot, "double_buffer_drain": drain}


def bucket_collectives(cfg) -> dict[str, int]:
    """Phases 6c and 6d: the pipelined broadcast and concurrent AG/RS on
    the flat f32 bucket of layer 0 of the seeded smollm-135m weights.
    Returns the launches of one concurrent AG/RS call (counts zeroed
    before, read after): one ring-allgather launch of the ring schedule
    and one launch of its transpose, each running seven entries."""
    def layer0(tree):
        if isinstance(tree, dict):
            return {k: layer0(v) for k, v in tree.items()}
        return torch.from_numpy(tree[0]).cuda()

    layer = layer0(bridge.random_params(cfg, seed=0)["blocks"])
    flat, unflatten = flatten_bucket(layer, pad_to=8 * 64)
    if not torch.equal(unflatten(flat)["mlp"]["w_up"], layer["mlp"]["w_up"]):
        raise AssertionError("flatten_bucket did not round-trip")
    mesh = StackedMesh(data=8, model=1)
    x = torch.stack([flat + r for r in range(8)])   # rank r's row; only root's is sent
    row = {"bucket_elements": flat.numel()}
    for root in (0, 7):
        for chunks in (8, 64):
            bcast = C.make_broadcast(mesh, "data", root=root, n_chunks=chunks)
            if not torch.equal(bcast(x), x[root].expand(8, -1)):
                raise AssertionError(f"broadcast from {root} in {chunks} chunks differs")
            row[f"broadcast_root{root}_chunks{chunks}_wall_ms_median"] = statistics.median(
                _wall(lambda: bcast(x))) * 1e3
    ag = flat.reshape(8, -1)
    rs = torch.stack([flat * (r + 1) for r in range(8)])
    torch.cuda.synchronize()
    _zero_counts()   # counts from here to the read are concurrent AG/RS's
    got = C.concurrent_ag_rs_local(ag, rs)
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(counts, 0), "ring_allgather": 1, "entries_ring": 7,
            "ring_allgather_transpose": 1, "transpose_entries_ring": 7}
    if counts != want:
        raise AssertionError(f"concurrent AG/RS launched {counts}, expected {want}")
    if not (torch.equal(got[0], C.ring_allgather_local(ag))
            and torch.equal(got[1], C.ring_reduce_scatter_local(rs, direction=-1))):
        raise AssertionError("concurrent AG/RS differs from the separate calls")
    row["concurrent_ag_rs_two_streams_wall_ms_median"] = statistics.median(
        _wall(lambda: C.concurrent_ag_rs_local(ag, rs))) * 1e3
    row["concurrent_ag_rs_one_stream_wall_ms_median"] = statistics.median(
        _wall(lambda: C._concurrent_ag_rs(ag, rs, overlap=False))) * 1e3
    row["concurrent_ag_rs_two_streams_device_ms"] = _device_ms(
        lambda: C.concurrent_ag_rs_local(ag, rs))
    row["concurrent_ag_rs_one_stream_device_ms"] = _device_ms(
        lambda: C._concurrent_ag_rs(ag, rs, overlap=False))
    print("[bucket] broadcast and concurrent AG/RS bitwise as required: " + json.dumps(row),
          flush=True)
    return counts


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
    build.build()
    print(f"[build] {len(build.SOURCES)} kernels built in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    cfg = get_model_config("smollm-135m")
    small = reduced(cfg)
    t0 = time.perf_counter()
    cases, ring_err = check_kernel()
    print(f"[kernel] ring_step == plain on {cases} cases, max abs err {ring_err} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    ag_cases, ag_err = check_allgather()
    print(f"[kernel] ring_allgather == plain steps on every prefix: {ag_cases} launches, max "
          f"abs err {ag_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    agt_cases, agt_err = check_allgather_transpose()
    print(f"[kernel] ring_allgather_transpose == plain on every prefix: {agt_cases} launches, "
          f"max abs err {agt_err} ({time.perf_counter() - t0:.1f} s)", flush=True)
    train_cases = matmul_cases(cfg, 8, TRAIN_SHAPE.global_batch // 8 * TRAIN_SHAPE.seq_len,
                               torch.bfloat16, train=True)
    path_cases = {**train_cases,                                    # full-width serving:
                  **matmul_cases(cfg, 8, PROMPT, torch.bfloat16, train=False, head_m=1),
                  **matmul_cases(cfg, 8, 1, torch.bfloat16, train=False),   # decode
                  # the reduced f32 references: prefill, decode, train, 8 ranks and 1
                  **matmul_cases(small, 8, 32, torch.float32, train=False, head_m=1),
                  **matmul_cases(small, 1, 256, torch.float32, train=False, head_m=8),
                  **matmul_cases(small, 8, 1, torch.float32, train=False),
                  **matmul_cases(small, 1, 8, torch.float32, train=False),
                  **matmul_cases(small, 8, 64, torch.float32, train=True),
                  **matmul_cases(small, 1, 512, torch.float32, train=True)}
    t0 = time.perf_counter()
    mm_err = check_matmul(path_cases)
    print(f"[kernel] matmul within limits of plain on {len(path_cases)} path shapes, every "
          f"bf16 one on the wgmma path, max abs err {mm_err} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    edge_cases = check_matmul_edges()
    print(f"[kernel] matmul == plain (integer inputs, exact) on {edge_cases} edge cases of the "
          "wgmma and wmma paths", flush=True)
    t0 = time.perf_counter()
    rx = check_rx_kernels()
    print("[kernel] receive datapath == plain (exact): "
          + json.dumps({k: {"cases": c, "max_abs_err": e} for k, (c, e) in rx.items()})
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[kernel] chunk_reassembly and bitmap_popcount: {check_no_sync()} calls under "
          "set_sync_debug_mode('error'), none synchronised", flush=True)
    print(f"[collectives] {check_collectives()} cases equal the "
          "plain gather", flush=True)
    err = check_small_reference()
    print(f"[reference] reduced f32 sharded vs single-rank: max abs logit diff {err}",
          flush=True)
    worst = check_train_reference()
    print(f"[reference] reduced f32 train step within limits; largest relative loss "
          f"difference {worst}", flush=True)

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the serving path's
    serve()
    serve_counts = _counts()
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(serve_counts)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()   # counts from here to the read are the training path's
    per_step, train_metrics = train()
    train_counts = _counts()
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(train_counts)}", flush=True)
    t0 = time.perf_counter()
    _zero_counts()   # counts from here to the read are the training options'
    train_options(train_metrics)
    option_counts = _counts()
    print(f"[train-options] launches {json.dumps(option_counts)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for name in MODEL_KERNELS:
        launches[name] = serve_counts[name] + train_counts[name] + option_counts[name]
        if train_counts[name] == 0 or option_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the training path")
    if serve_counts["ring_allgather"] == 0 or serve_counts["matmul"] == 0:
        raise AssertionError(f"a kernel was not launched on the serving path: {serve_counts}")
    if any(serve_counts[k] or train_counts[k] or option_counts[k] for k in OFF_PATH):
        raise AssertionError(f"a serving or training product left the wgmma path: serving "
                             f"{serve_counts}, training {train_counts}, {option_counts}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packet_counts, card = packet_path()   # zeroes the counts before driving the path
    print(f"[packet] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(packet_counts)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    launches.update({name: packet_counts[name] for name in PACKET_KERNELS})
    t0 = time.perf_counter()
    drain_cases, drain_err = check_drain()
    print(f"[kernel] double_buffer_drain == plain (exact) on {drain_cases} cases", flush=True)
    layer_counts, layer = layer_path()   # zeroes the counts before driving the path
    launches.update({name: layer_counts[name] for name in LAYER_KERNELS})
    bucket_counts = bucket_collectives(cfg)
    launches["ring_step"] = layer_counts["ring_step"]
    launches["ring_allgather"] += bucket_counts["ring_allgather"]
    launches["ring_allgather_transpose"] += bucket_counts["ring_allgather_transpose"]
    print(f"[layer] phase 6 checks passed ({time.perf_counter() - t0:.1f} s)", flush=True)

    ring = time_ring_steps(cfg)
    print(f"[ring] mean over one layer's leaves: {json.dumps(ring)}", flush=True)
    mm = time_matmul(train_cases)
    print(f"[matmul] one train step's {mm['launches']} launches (mcast counted "
          f"{per_step['matmul']}): {json.dumps(mm)}", flush=True)
    rx_t = time_rx_kernels(card)
    t0 = time.perf_counter()
    layer_t = time_layer(layer)
    print(f"[layer] timed ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)

    replaces = {"pool": ("src/repro_torch/csrc/pool.cu",
                         "src/repro/kernels/pool.py:53, src/repro/kernels/pool.py:86"),
                "bitmap_pack": ("src/repro_torch/csrc/bitmap.cu", "src/repro/kernels/bitmap.py:40"),
                "bitmap_or_rows": ("src/repro_torch/csrc/bitmap.cu",
                                   "src/repro/core/packet.py:952"),
                "bitmap_popcount": ("src/repro_torch/csrc/bitmap.cu",
                                    "src/repro/kernels/bitmap.py:78"),
                "chunk_reassembly": ("src/repro_torch/csrc/chunk_reassembly.cu",
                                     "src/repro/kernels/chunk_reassembly.py:41")}
    rx_rows = [{"name": name, "route": "cuda", "source": replaces[name][0],
                "replaces": replaces[name][1], "launches": launches[name],
                "max_abs_err": rx[name][1], "ms": rx_t[name]["ms"],
                "plain_ms": rx_t[name]["plain_ms"], "bound_ms": rx_t[name]["bound_ms"],
                "bound_by": "bytes", "library_ms": rx_t[name]["library_ms"]}
               for name in PACKET_KERNELS]
    agmm_t, drain_t = layer_t["allgather_matmul"], layer_t["double_buffer_drain"]
    layer_rows = [
        {"name": "allgather_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/collective_matmul.py:68",
         "launches": launches["allgather_matmul"], "max_abs_err": agmm_t["max_abs_err"],
         "ms": agmm_t["ms"], "plain_ms": agmm_t["plain_ms"], "bound_ms": agmm_t["bound_ms"],
         "bound_by": agmm_t["bound_by"], "library_ms": agmm_t["library_ms"]},
        {"name": "double_buffer_drain", "route": "cuda",
         "source": "src/repro_torch/csrc/double_buffer_drain.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:94",
         "launches": launches["double_buffer_drain"], "max_abs_err": drain_err,
         "ms": drain_t["ms"], "plain_ms": drain_t["plain_ms"], "bound_ms": drain_t["bound_ms"],
         "bound_by": "bytes", "library_ms": drain_t["library_ms"]}]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "ring_allgather", "route": "cuda",
         "source": "src/repro_torch/csrc/ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_allgather"], "max_abs_err": ag_err,
         "ms": ring["gather_ms"], "plain_ms": ring["gather_plain_ms"],
         "bound_ms": ring["gather_bound_ms"], "bound_by": "bytes",
         "library_ms": ring["gather_library_ms"]},
        {"name": "ring_allgather_transpose", "route": "cuda",
         "source": "src/repro_torch/csrc/ring_allgather_transpose.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_allgather_transpose"], "max_abs_err": agt_err,
         "ms": ring["transpose_ms"], "plain_ms": ring["transpose_plain_ms"],
         "bound_ms": ring["transpose_bound_ms"], "bound_by": "bytes",
         "library_ms": ring["transpose_library_ms"]},
        {"name": "ring_step", "route": "cuda", "source": "src/repro_torch/csrc/ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather.py:46",
         "launches": launches["ring_step"], "max_abs_err": ring_err, "ms": ring["ms"],
         "plain_ms": ring["plain_ms"], "bound_ms": ring["bound_ms"], "bound_by": "bytes",
         "library_ms": ring["library_ms"]},
        {"name": "matmul", "route": "cuda", "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/collective_matmul.py:43",
         "launches": launches["matmul"], "max_abs_err": mm_err,
         "ms": mm["ms_per_launch"], "plain_ms": mm["plain_ms_per_launch"],
         "bound_ms": mm["bound_ms_per_launch"], "bound_by": "operations",
         "library_ms": mm["library_ms_per_launch"]}, *rx_rows, *layer_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""One ring step and one concurrent AG/RS call, for one or more source
trees in turn, on one CUDA card:

    python3 scripts/ring_step_shapes.py                    # this tree
    python3 scripts/ring_step_shapes.py OLD . . OLD        # OLD: another checkout

``ring_step`` runs at the rank-slot lengths of smollm-135m's sharded
leaves at P = 8 (13,824, 41,472 and 110,592 bf16: wk and wv, wq and wo,
the MLP's) and of layer 0's flat f32 bucket (``flatten_bucket``, the
bucket that phase 6d of ``chip_smoke.py`` gathers), each with three
entries: a whole slot, a split at n / 2 and a broadcast round's mask (4
rounds, round 1). For each: ms a call from Python, host issue and device
ms (``chip_smoke._time``, ``_host_ms`` and ``_device_ms``), and the bound,
the moving slots read and written once over 3.35 TB/s (2 P n itemsize
bytes, a quarter of it for the masked entry). Then
``concurrent_ag_rs_local`` on the bucket's shards: the median wall of
``chip_smoke.REPEATS`` synchronised calls, the host issue and the device
ms, on two streams and on one (``_concurrent_ag_rs(overlap=False)``); and
its reduce-scatter half alone, ms a call, host issue and device ms, both
ways a tree offers it: one launch of the gather's transpose
(``ring_reduce_scatter_local(rs, direction=-1)``) and, where the tree still
has the one-step transpose kernel (``ring_step_transpose``), the seven
reversed one-step launches on a copy of ``rs`` and the copy of their
diagonal, held bitwise to the one launch; with the bound of the one
launch, ``rs`` read once and the result written once over 3.35 TB/s.

Each tree runs in a process of its own, in the order given, with this
tree's ``chip_smoke`` on that tree's ``src/repro_torch`` (imported first),
and builds its kernels into its own ``build/``. Prints the card's name and
power limit, a JSON line per tree, and a last JSON line of every run's
figures and each tree's medians over its runs.

    python3 scripts/ring_step_shapes.py --host-ab OLD

times the two ``ring_step`` wrappers in one process instead: OLD's
``kernels/ring_allgather.py`` (its step launching OLD's own library, built
into OLD's ``build/``) and this tree's, on the same buffers at every shape
and entry above, alternating for ``HOST_AB_ROUNDS`` rounds (``_time`` and
``_host_ms`` each round), after checking that both give the same bits.
Prints the medians and every sample.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF_SLOTS = (13824, 41472, 110592)   # d x kv / 8, d x d / 8, d x d_ff / 8 at smollm-135m
P = 8
HOST_AB_ROUNDS = 20


def _entries(n: int) -> dict[str, dict]:
    return {"ring": {}, "bidi": {"split": n // 2}, "bcast": {"rounds": 4, "active_round": 1}}


def _worker(tree: str, bucket: int) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import repro_torch  # noqa: F401  (this tree's package, before chip_smoke adds ROOT/src)
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as S
    from repro_torch.core import collectives as C
    from repro_torch.kernels import ring_allgather as K
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for n, dtype in [(n, torch.bfloat16) for n in LEAF_SLOTS] + [(bucket, torch.float32)]:
        buf = torch.randn((1, P, P, n), generator=gen, device="cuda").to(dtype)
        for kind, kw in _entries(n).items():
            moved = 2 * P * n * buf.element_size() // kw.get("rounds", 1)

            def step(kw=kw):
                return K.ring_step(buf, 0, **kw)

            rows.append({"n": n, "dtype": str(dtype), "entry": kind, "ms": S._time(step),
                         "host_ms": S._host_ms(step), "device_ms": S._device_ms(step),
                         "bound_ms": moved / S.HBM_BYTES_PER_S * 1e3})
            print(json.dumps({"tree": tree, **rows[-1]}), flush=True)
    ag = torch.randn((P, bucket), generator=gen, device="cuda")
    rs = torch.randn((P, P * bucket), generator=gen, device="cuda")
    calls = {"two_streams": lambda: C.concurrent_ag_rs_local(ag, rs),
             "one_stream": lambda: C._concurrent_ag_rs(ag, rs, overlap=False)}
    ag_rs = {}
    for name, fn in calls.items():
        ag_rs[f"{name}_wall_ms"] = statistics.median(S._wall(fn)) * 1e3
        ag_rs[f"{name}_host_ms"] = S._host_ms(fn)
        ag_rs[f"{name}_device_ms"] = S._device_ms(fn)
    halves = {"one_launch": lambda: C.ring_reduce_scatter_local(rs, direction=-1)}
    if hasattr(K, "ring_step_transpose"):
        halves["seven_steps"] = lambda: _seven_steps(K, rs)
        if not torch.equal(halves["seven_steps"](), halves["one_launch"]()):
            raise AssertionError("the seven transposed steps differ from the one launch")
    rs_half = {"bound_ms": (P * P + P) * bucket * 4 / S.HBM_BYTES_PER_S * 1e3}
    for name, fn in halves.items():
        rs_half[f"{name}_ms"] = S._time(fn)
        rs_half[f"{name}_host_ms"] = S._host_ms(fn)
        rs_half[f"{name}_device_ms"] = S._device_ms(fn)
    print("RESULT " + json.dumps({"tree": tree, "steps": rows, "concurrent_ag_rs": ag_rs,
                                  "reduce_scatter_half": rs_half}), flush=True)


def _seven_steps(K, rs):
    """Concurrent AG/RS's reduce-scatter half as it ran before it took one
    launch: a copy of the contributions, the P - 1 transposed ring steps in
    reverse order, one launch each, and a copy of the diagonal."""
    acc = rs.reshape(P, P, -1).clone()
    for t in reversed(range(P - 1)):
        K.ring_step_transpose(acc, t)
    return acc.diagonal(dim1=-3, dim2=-2).transpose(-1, -2).contiguous()


def _host_ab(old_tree: str, bucket: int) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as S
    from repro_torch.kernels import build
    from repro_torch.kernels import ring_allgather as new
    old_src = os.path.join(os.path.abspath(old_tree), "src")
    lib = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; print(build.build(('ring_step',))['ring_step'])",
         old_src], capture_output=True, text=True, check=True).stdout.strip()
    build._libs["ring_step"] = ctypes.PyDLL(lib)   # the old wrapper's entry, from OLD's build
    spec = importlib.util.spec_from_file_location(
        "old_ring_allgather", os.path.join(old_src, "repro_torch", "kernels", "ring_allgather.py"))
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    wrappers = {"old": old.ring_step, "new": new.ring_step}
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for n, dtype in [(n, torch.bfloat16) for n in LEAF_SLOTS] + [(bucket, torch.float32)]:
        base = torch.randn((1, P, P, n), generator=gen, device="cuda").to(dtype)
        for kind, kw in _entries(n).items():
            outs = {name: fn(base.clone(), 0, **kw) for name, fn in wrappers.items()}
            if not torch.equal(outs["old"], outs["new"]):
                raise AssertionError(f"the two ring_step wrappers differ at {n}, {kind}")
            buf = base.clone()
            samples = {name: {"ms": [], "host_ms": []} for name in wrappers}
            for r in range(HOST_AB_ROUNDS):
                for name in (("old", "new") if r % 2 == 0 else ("new", "old")):
                    fn = wrappers[name]

                    def step(fn=fn, kw=kw):
                        return fn(buf, 0, **kw)

                    samples[name]["ms"].append(S._time(step))
                    samples[name]["host_ms"].append(S._host_ms(step))
            rows.append({"n": n, "dtype": str(dtype), "entry": kind,
                         "median": {name: {key: statistics.median(v) for key, v in s.items()}
                                    for name, s in samples.items()},
                         "samples": samples})
            print(json.dumps({k: rows[-1][k] for k in ("n", "dtype", "entry", "median")}),
                  flush=True)
    print(json.dumps({"host_ab": {"old": old_tree, "rounds": HOST_AB_ROUNDS, "steps": rows}}))


def _bucket_slot() -> int:
    """Elements a rank holds of layer 0's flat bucket, as phase 6d builds it."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_model_config
    from repro_torch.sharding.fsdp import flatten_bucket
    blocks = bridge.random_params(get_model_config("smollm-135m"), seed=0)["blocks"]

    def layer0(tree):
        if isinstance(tree, dict):
            return {k: layer0(v) for k, v in tree.items()}
        return torch.from_numpy(tree[0])

    flat, _ = flatten_bucket(layer0(blocks), pad_to=P * 64)
    return flat.numel() // P


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], int(sys.argv[3]))
        return 0
    trees = sys.argv[1:] or [ROOT]
    import torch
    if not torch.cuda.is_available():
        print("ring_step_shapes: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    bucket = _bucket_slot()
    if sys.argv[1:2] == ["--host-ab"]:
        _host_ab(sys.argv[2], bucket)
        return 0
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               str(bucket)], capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.rsplit("RESULT ", 1)[1]))
    medians = {}
    for tree in dict.fromkeys(trees):
        mine = [r for r in results if r["tree"] == tree]
        medians[tree] = {
            "steps": [{**{k: row[k] for k in ("n", "dtype", "entry", "bound_ms")},
                       **{key: statistics.median(r["steps"][i][key] for r in mine)
                          for key in ("ms", "host_ms", "device_ms")}}
                      for i, row in enumerate(mine[0]["steps"])],
            **{part: {key: statistics.median(r[part][key] for r in mine)
                      for key in mine[0][part]}
               for part in ("concurrent_ag_rs", "reduce_scatter_half")}}
    print(json.dumps({"trees": trees, "bucket_slot": bucket, "runs": results,
                      "median": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

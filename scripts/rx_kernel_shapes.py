#!/usr/bin/env python3
"""The pool scan (csrc/pool.cu), the bitmap pack and the OR of packed rows
(csrc/bitmap.cu) at every shape the packet Broadcasts A and B of
``chip_smoke.py`` give them, for one or more source trees in turn, on one
CUDA card:

    python3 scripts/rx_kernel_shapes.py                    # this tree
    python3 scripts/rx_kernel_shapes.py OLD . . OLD        # OLD: another checkout

The shapes come from the broadcasts' round traces on the CPU
(``chip_smoke.rx_shapes``): seven pool calls, 516 packs (five in the
broadcasts, 511 single rows in A's replay) and five ORs (one a recovery
round, of 512 words). Each tree is timed in a
process of its own, in the order given, by ``chip_smoke.time_rx_shapes``
of this tree run on that tree's ``src/repro_torch`` (imported first, so
that ``chip_smoke``'s imports find it): ms a call from Python, host issue,
device ms, the plain version, the bound and a yardstick per shape. Each
tree builds its kernels into its own ``build/``. Prints the card's
name and power limit, one JSON line per shape and tree, and a last JSON
line of ms, host and device ms per shape, a list in the trees' order,
with the median over the runs of each tree.

    python3 scripts/rx_kernel_shapes.py --host-ab OLD

times the host path of the replay's single-row pack alone: OLD's
``kernels/bitmap.py`` wrapper and this tree's, in one process, on the same
(16384,) bool flags, alternating for ``HOST_AB_ROUNDS`` rounds (``_time``
and ``_host_ms`` each round). Both wrappers launch this tree's kernel
(they share its ``build`` and C entry, whose arguments did not change),
so only their Python differs. Prints the medians and every sample.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_AB_ROUNDS = 20


def _worker(tree: str, calls: dict, service: float) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import repro_torch  # noqa: F401  (this tree's package, before chip_smoke adds ROOT/src)
    sys.path.insert(0, ROOT)
    import chip_smoke
    calls = {"pool": [(tuple(shape), w, staging) for shape, w, staging in calls["pool"]],
             **{name: [tuple(shape) for shape in calls[name]]
                for name in ("bitmap_pack", "bitmap_or_rows")}}
    rows = chip_smoke.time_rx_shapes(calls, service)
    print("RESULT " + json.dumps({"tree": tree, **rows}), flush=True)


def _host_ab(old_tree: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke
    from repro_torch.kernels import bitmap as new
    spec = importlib.util.spec_from_file_location(
        "old_bitmap", os.path.join(old_tree, "src", "repro_torch", "kernels", "bitmap.py"))
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    gen = torch.Generator(device="cuda").manual_seed(6)
    flags = torch.rand((16384,), generator=gen, device="cuda") < 1e-3
    if not torch.equal(old.bitmap_pack(flags).view(torch.int32),
                       new.bitmap_pack(flags).view(torch.int32)):
        raise AssertionError("the two wrappers pack different words")
    wrappers = {"old": old.bitmap_pack, "new": new.bitmap_pack}
    samples = {name: {"ms": [], "host_ms": []} for name in wrappers}
    for r in range(HOST_AB_ROUNDS):
        for name in (("old", "new") if r % 2 == 0 else ("new", "old")):
            fn = wrappers[name]
            samples[name]["ms"].append(chip_smoke._time(lambda: fn(flags)))
            samples[name]["host_ms"].append(chip_smoke._host_ms(lambda: fn(flags)))
    medians = {name: {key: statistics.median(v) for key, v in s.items()}
               for name, s in samples.items()}
    print(json.dumps({"host_ab": {"old": old_tree, "shape": [16384], "rounds": HOST_AB_ROUNDS,
                                  "median": medians, "samples": samples}}))


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2], json.loads(sys.argv[3]), float(sys.argv[4]))
        return 0
    trees = sys.argv[1:] or [ROOT]
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("rx_kernel_shapes: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if sys.argv[1:2] == ["--host-ab"]:
        _host_ab(sys.argv[2])
        return 0
    import chip_smoke
    from repro_torch.core import engine as E
    cpu = {name: chip_smoke._bcast(name, "cpu") for name in chip_smoke.BCASTS}
    calls = chip_smoke.rx_shapes(cpu)
    fab, workers = E.FabricParams(), E.WorkerParams(**chip_smoke.BCASTS["A"][2])
    service = fab.mtu / workers.thread_tput
    results = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               json.dumps(calls), repr(service)],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.rsplit("RESULT ", 1)[1]))
    kernels = ("pool", "bitmap_pack", "bitmap_or_rows")
    summary = {kernel: [{"shape": row["shape"], **{key: [r[kernel][k][key] for r in results]
                                                    for key in ("ms", "host_ms", "device_ms")}}
                        for k, row in enumerate(results[0][kernel])]
               for kernel in kernels}
    medians = {tree: {kernel: [{"shape": row["shape"],
                                **{key: statistics.median(r[kernel][k][key] for r in results
                                                          if r["tree"] == tree)
                                   for key in ("ms", "host_ms", "device_ms")}}
                               for k, row in enumerate(results[0][kernel])]
                      for kernel in kernels}
               for tree in dict.fromkeys(trees)}
    print(json.dumps({"trees": trees, **summary, "median": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Host ms of the packet paths of ``chip_smoke.py`` phases 5 and 5b on the
card: the Broadcasts A (512 hosts) and B (64 hosts) and the Allgathers AG-A
(128 hosts, lossless) and AG-B (188 hosts, 1e-3 loss), each a warm-up call
and five timed calls (host clock around a synchronised call; median, min,
max).

    python3 scripts/packet_host_ab.py OLD . . OLD   # source trees in turns, a process each
    python3 scripts/packet_host_ab.py --pinned      # this tree: the link masks' and the
                                                    # jitter's host buffers pinned or
                                                    # pageable, in turns in one process

OLD is another checkout's root (for example ``git archive`` of the parent
unpacked under ``build/``). Prints one JSON line per tree or per call.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _calls(E, PK, np):
    fab, ge = E.FabricParams(), PK.GilbertElliottLoss.from_rate(0.01, mean_burst=8.0)
    return {
        "A": lambda: PK.simulate_packet_broadcast(
            512, 64 << 20, fab, E.WorkerParams(n_recv_workers=8), np.random.default_rng(0),
            loss=1e-3, device="cuda"),
        "B": lambda: PK.simulate_packet_broadcast(
            64, 64 << 20, fab, E.WorkerParams(), np.random.default_rng(4), loss=ge,
            device="cuda"),
        "AG-A": lambda: PK.simulate_packet_allgather(
            128, 16 << 20, E.FabricParams(jitter=0.0), E.WorkerParams(n_recv_workers=8),
            np.random.default_rng(0), 4, device="cuda"),
        "AG-B": lambda: PK.simulate_packet_allgather(
            188, 4 << 20, fab, E.WorkerParams(n_recv_workers=8), np.random.default_rng(0), 4,
            loss=1e-3, device="cuda"),
    }


def _ms(fn, torch) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _stats(samples: list[float]) -> tuple[float, float, float]:
    return statistics.median(samples), min(samples), max(samples)


def one_tree(tree: str) -> None:
    """The four calls of ``tree``'s port, in this process."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import packet as PK
    from repro_torch.kernels import build

    build.build(("pool", "bitmap"))
    out = {}
    for name, fn in _calls(E, PK, np).items():
        fn()
        out[name] = _stats([_ms(fn, torch) for _ in range(5)])
    print(json.dumps({"tree": tree, "host_ms_median_min_max": out}), flush=True)


def pinned_variants() -> None:
    """This tree's calls with the host buffers of the link masks
    (``packet._mask_rows``) and the jitter (``packet._jitter_on``) pinned,
    as the port has them, or pageable, four variants in turns."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import packet as PK
    from repro_torch.kernels import build

    build.build(("pool", "bitmap"))
    jit, rows = PK._jitter_on, PK._mask_rows

    def jit_pageable(rng, jitter, n, device):
        return torch.from_numpy(rng.uniform(0.0, jitter, size=n)).to(device)

    def rows_pageable(n_rows, width, device):
        return torch.zeros((n_rows + 1, width), dtype=torch.bool)

    variants = {"pinned": (jit, rows), "pageable_jitter": (jit_pageable, rows),
                "pageable_masks": (jit, rows_pageable),
                "pageable_both": (jit_pageable, rows_pageable)}
    for name, fn in _calls(E, PK, np).items():
        samples = {v: [] for v in variants}
        for rep in range(4):
            order = list(variants.items())
            for v, (j, r) in (order if rep % 2 == 0 else order[::-1]):
                PK._jitter_on, PK._mask_rows = j, r
                fn()
                samples[v].append(_ms(fn, torch))
        PK._jitter_on, PK._mask_rows = jit, rows
        print(json.dumps({"call": name, "host_ms_median_min_max":
                          {v: _stats(s) for v, s in samples.items()}}), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--pinned"]:
        pinned_variants()
    elif argv[:1] == ["--one"]:
        one_tree(os.path.abspath(argv[1]))
    else:
        for tree in argv or [ROOT]:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

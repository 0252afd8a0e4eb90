#!/usr/bin/env python
"""The production dry-run's table: one row per (arch, shape) cell, the
single-pod and the multi-pod record side by side, from the JSON records
that ``python -m repro_torch.launch.dryrun --all --out DIR`` writes.

    python -m repro_torch.launch.dryrun --all --jobs 5 --out build/dry1
    python -m repro_torch.launch.dryrun --all --multi-pod --jobs 5 --out build/dry2
    python scripts/dryrun_table.py build/dry1 build/dry2

Columns, per rank (GB = 1e9 bytes): the arguments and the peak (arguments +
temporaries) on (16, 16) / (2, 16, 16), whether the peak fits the card's
memory on both, the counted flops over the analytic model's implementation
flops, the counted collective bytes by kind (AG all-gather, RS
reduce-scatter, CP collective-permute) and the analytic model's total
collective bytes a device.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def _load(d: str) -> dict[tuple[str, str], dict]:
    out = {}
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"])] = rec
    return out


def _gb(x: float) -> str:
    return f"{x / 1e9:.3g}"


_KINDS = (("all-gather", "AG"), ("reduce-scatter", "RS"), ("collective-permute", "CP"))


def _coll(rec: dict) -> str:
    per = rec["collectives_hlo"]["per_device_bytes"]
    return " ".join(f"{tag} {_gb(per[k])}" for k, tag in _KINDS if per.get(k))


def main(argv: list[str]) -> int:
    one, two = (_load(d) for d in argv[:2])
    print("| cell | args GB | peak GB | fits | flops / analytic | collectives GB, 1 pod "
          "| collectives GB, 2 pods | analytic GB, 1 / 2 pods |")
    print("|---|---|---|---|---|---|---|---|")
    bad = 0
    for key in sorted(one):
        a, b = one[key], two.get(key)
        if not a["ok"] or b is None or not b["ok"]:
            bad += 1
            print(f"| {key[0]} {key[1]} | failed | | | | | | |")
            continue
        ma, mb = a["memory_analysis"], b["memory_analysis"]
        ratio = a["cost_analysis_raw"]["flops"] / a["analytic"]["impl_flops"]
        ana = [r["analytic"]["collective_bytes_per_device"]["total"] for r in (a, b)]
        print(f"| {key[0]} {key[1]} | {_gb(ma['argument_size_in_bytes'])} / "
              f"{_gb(mb['argument_size_in_bytes'])} | {_gb(ma['peak_bytes'])} / "
              f"{_gb(mb['peak_bytes'])} | {'yes' if a['fits'] else 'no'} / "
              f"{'yes' if b['fits'] else 'no'} | {ratio:.3f} | {_coll(a)} | {_coll(b)} | "
              f"{_gb(ana[0])} / {_gb(ana[1])} |")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

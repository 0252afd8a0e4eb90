"""Launch facade for the training-run co-simulation.

String-addressed front door over core/train_sim.py: models and shapes by
registry name, fabrics by spec name ("abstract", "fattree", "island",
"torus") sized automatically to the data-parallel group. Keeps scripts and
benchmarks free of topology construction:

    from repro_torch.launch import H100, simulate_training_run
    r = simulate_training_run("granite-34b", n_hosts=64, fabric="island",
                              policy="split", chip=H100)
    print(r.step_time, r.mfu, r.bubble_fraction)
"""
from __future__ import annotations

from repro_torch.core.train_sim import (H100, TPU_V5E, ChipConstants,  # noqa: F401
                                        LayerProfile, TrainingRunResult,
                                        derive_layer_profiles, make_fabric,
                                        sweep_training_runs)
from repro_torch.core.train_sim import simulate_training_run as _core_simulate


def simulate_training_run(model, shape="train_4k", *, n_hosts: int,
                          fabric: str | None = "abstract",
                          oversubscription: float = 4.0,
                          island_size: int = 8,
                          **kw) -> TrainingRunResult:
    """core/train_sim.simulate_training_run with ``fabric=`` as a spec
    string; the topology is sized to the dp group (n_hosts // pp — the
    hosts of ONE pipeline stage share a fabric). All other keywords pass
    through (fabric *parameters* go via ``fabric_params=``; ``device=``,
    default ``cuda``, where the engines solve)."""
    if "topology" in kw:
        raise TypeError("pass fabric=<spec>; use core.train_sim directly "
                        "for explicit topology objects")
    dp = n_hosts // kw.get("pp", 1)
    topo = make_fabric(fabric, dp, oversubscription=oversubscription,
                       island_size=island_size)
    fabric_params = kw.pop("fabric_params", None)
    return _core_simulate(model, shape, n_hosts=n_hosts, topology=topo,
                          fabric=fabric_params, **kw)

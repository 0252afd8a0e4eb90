"""The port's FSDP step timeline and multi-job contention against the JAX
package's, on the CPU: ``build_fsdp_step``, ``simulate_fsdp_step`` for every
policy on the abstract NIC and on routed ``FatTree`` fabrics (full bisection
and oversubscribed), at the fluid fidelity and with the packet loss overlay,
uniform, with ``layers=`` and with ``model=``; ``execute`` over the
schedule; ``sweep_fsdp_contention``'s rows; ``simulate_multi_job``. The same
arguments and numpy generator seeds go into both packages, and every field
must be equal exactly, the generators' next draws included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import get_model_config as ref_config
from repro.core import engine as ref_engine
from repro.core import sched_ir as ref_ir
from repro.core import topology as ref_topo
from repro.models.model_builder import count_params_analytic as ref_count
from repro_torch.configs.base import EncDecConfig
from repro_torch.configs.registry import get_model_config
from repro_torch.core import engine, sched_ir, topology
from repro_torch.models.model_builder import count_params_analytic


def assert_same(a, b, ctx=""):
    assert type(a).__name__ == type(b).__name__, ctx
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, dict):
            assert list(x.items()) == list(y.items()), (ctx, f.name)
        else:
            assert x == y, (ctx, f.name, x, y)


FABRICS = [None, 1.0, 4.0]   # the abstract NIC, FatTree(k=8, 16 hosts) at oversubscription o


def _fabrics(o):
    if o is None:
        return None, None
    return (topology.FatTree(k=8, n_hosts=16, oversubscription=o),
            ref_topo.FatTree(k=8, n_hosts=16, oversubscription=o))


def step_both(o, seed=0, **kw):
    t_topo, r_topo = _fabrics(o)
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = engine.simulate_fsdp_step(topology=t_topo, rng=rng_t, device="cpu", **kw)
    want = ref_engine.simulate_fsdp_step(topology=r_topo, rng=rng_r, **kw)
    return got, want, rng_t, rng_r


@pytest.mark.parametrize("fidelity", ["fluid", "packet"])
@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
@pytest.mark.parametrize("o", FABRICS)
def test_fsdp_step_matches_reference(o, policy, fidelity):
    loss = 1e-3 if fidelity == "packet" else None
    got, want, rng_t, rng_r = step_both(o, n_layers=3, layer_bytes=64e6, p=16, policy=policy,
                                        fidelity=fidelity, loss=loss)
    assert_same(got, want, ctx=f"{o} {policy} {fidelity}")
    assert 0.0 < got.bubble_fraction < 1.0
    assert rng_t.random() == rng_r.random()


@pytest.mark.parametrize("fidelity", ["fluid", "packet"])
@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
@pytest.mark.parametrize("o", [None, 4.0])
def test_host_progress_engine_matches_reference(o, policy, fidelity):
    """progress_engine="host": the receive datapath on host cores (its
    throughput from the event engine, ``datapath_tput``), the compute
    stretched by the stolen cores; uniform and with ``layers=``."""
    loss = 1e-3 if fidelity == "packet" else None
    for cores, total in ((2, 108), (1, 16), (4, 54)):
        got, want, rng_t, rng_r = step_both(o, n_layers=4, layer_bytes=64e6, p=16,
                                            policy=policy, fidelity=fidelity, loss=loss,
                                            progress_engine="host", host_cores=cores,
                                            host_total_cores=total)
        assert_same(got, want, ctx=f"host {o} {policy} {fidelity} {cores}/{total}")
        assert rng_t.random() == rng_r.random()
        assert got.progress_engine == "host" and got.datapath_tput > 0
        dpa_run, _, _, _ = step_both(o, n_layers=4, layer_bytes=64e6, p=16, policy=policy,
                                     fidelity=fidelity, loss=loss)
        assert got.step_time > dpa_run.step_time and dpa_run.datapath_tput is None
    layers_t = [engine.LayerProfile(1e-3 * (i + 1), 2e-3 * (i + 1), 16e6 * (i + 1))
                for i in range(3)]
    layers_r = [ref_engine.LayerProfile(lp.fwd_s, lp.bwd_s, lp.layer_bytes) for lp in layers_t]
    t_topo, r_topo = _fabrics(o)
    got = engine.simulate_fsdp_step(layers=layers_t, p=16, policy=policy, topology=t_topo,
                                    fidelity=fidelity, loss=loss, rng=np.random.default_rng(3),
                                    progress_engine="host", host_cores=3, device="cpu")
    want = ref_engine.simulate_fsdp_step(layers=layers_r, p=16, policy=policy,
                                         topology=r_topo, fidelity=fidelity, loss=loss,
                                         rng=np.random.default_rng(3), progress_engine="host",
                                         host_cores=3)
    assert_same(got, want, ctx=f"host layers {o} {policy} {fidelity}")


@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
@pytest.mark.parametrize("o", [None, 4.0])
def test_fsdp_step_with_layers_matches_reference(o, policy):
    """Heterogeneous layers: the op template at the largest layer, each
    layer's flows scaled to its own bytes."""
    for fidelity in ("fluid", "packet"):
        layers_t = [engine.LayerProfile(1e-3 * (i + 1), 2e-3 * (i + 1), 16e6 * (i + 1))
                    for i in range(3)]
        layers_r = [ref_engine.LayerProfile(lp.fwd_s, lp.bwd_s, lp.layer_bytes)
                    for lp in layers_t]
        t_topo, r_topo = _fabrics(o)
        loss = 2e-3 if fidelity == "packet" else None
        got = engine.simulate_fsdp_step(layers=layers_t, p=16, policy=policy, topology=t_topo,
                                        fidelity=fidelity, loss=loss,
                                        rng=np.random.default_rng(3), device="cpu")
        want = ref_engine.simulate_fsdp_step(layers=layers_r, p=16, policy=policy,
                                             topology=r_topo, fidelity=fidelity, loss=loss,
                                             rng=np.random.default_rng(3))
        assert_same(got, want, ctx=f"layers {o} {policy} {fidelity}")


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", "rwkv6-7b",
                                  "recurrentgemma-9b", "phi-3-vision-4.2b", "whisper-base",
                                  "moonshot-v1-16b-a3b"])
def test_fsdp_step_from_a_model_config_matches_reference(arch):
    cfg, ref = get_model_config(arch), ref_config(arch)
    assert count_params_analytic(cfg) == ref_count(ref)
    for o, fidelity in ((None, "fluid"), (1.0, "packet")):
        t_topo, r_topo = _fabrics(o)
        loss = 1e-3 if fidelity == "packet" else None
        got = engine.simulate_fsdp_step(cfg, p=16, policy="split", topology=t_topo,
                                        fidelity=fidelity, loss=loss,
                                        rng=np.random.default_rng(0), device="cpu")
        want = ref_engine.simulate_fsdp_step(ref, p=16, policy="split", topology=r_topo,
                                             fidelity=fidelity, loss=loss,
                                             rng=np.random.default_rng(0))
        assert_same(got, want, ctx=f"{arch} {o} {fidelity}")
        assert got.n_layers == cfg.num_layers


def test_other_families_raise():
    """Every family is counted now: an encdec built from smollm's widths has
    the reference's count and FSDP step (none raises; the encdec runs at tp
    > 1 too, ``tests/test_torch_encdec_tp.py``)."""
    from repro.configs.base import EncDecConfig as RefEncDecConfig
    cfg = dataclasses.replace(get_model_config("smollm-135m"), family="encdec",
                              encdec=EncDecConfig())
    ref = dataclasses.replace(ref_config("smollm-135m"), family="encdec",
                              encdec=RefEncDecConfig())
    assert count_params_analytic(cfg) == ref_count(ref)
    assert_same(engine.simulate_fsdp_step(cfg, p=8, device="cpu"),
                ref_engine.simulate_fsdp_step(ref, p=8), ctx="encdec")


@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
def test_fsdp_schedule_and_execute_match_reference(policy):
    """``build_fsdp_step`` is the reference's graph (the same canonical key);
    ``execute`` over it equals the direct call, on both fidelities."""
    sched = sched_ir.build_fsdp_step(p=8, n_layers=3, layer_bytes=32e6, policy=policy,
                                     n_chains=4, hw_flops=100e12)
    ref = ref_ir.build_fsdp_step(p=8, n_layers=3, layer_bytes=32e6, policy=policy,
                                 n_chains=4, hw_flops=100e12)
    assert sched_ir.canonical_key(sched) == ref_ir.canonical_key(ref)
    assert sched.rounds() == ref.rounds() and sched.meta == ref.meta
    topo, r_topo = (topology.FatTree(k=4, n_hosts=8), ref_topo.FatTree(k=4, n_hosts=8))
    for fidelity, loss in (("fluid", None), ("packet", 1e-3)):
        got = sched_ir.execute(sched, engine.FabricParams(), engine.WorkerParams(),
                               np.random.default_rng(1), fidelity=fidelity, topology=topo,
                               loss=loss, device="cpu")
        want = ref_ir.execute(ref, ref_engine.FabricParams(), ref_engine.WorkerParams(),
                              np.random.default_rng(1), fidelity=fidelity, topology=r_topo,
                              loss=loss)
        direct = engine.simulate_fsdp_step(
            n_layers=3, layer_bytes=32e6, p=8, policy=policy, n_chains=4, hw_flops=100e12,
            topology=topology.FatTree(k=4, n_hosts=8), fidelity=fidelity, loss=loss,
            rng=np.random.default_rng(1), workers=engine.WorkerParams(), device="cpu")
        assert_same(got, want, ctx=f"execute {policy} {fidelity}")
        assert_same(got, direct, ctx=f"direct {policy} {fidelity}")
    with pytest.raises(ValueError, match="fidelities"):
        sched_ir.execute(sched, fidelity="analytic", device="cpu")


def test_sweep_rows_match_reference():
    kw = dict(ps=(8, 16, 64), layer_bytes=(64e6, 256e6), n_layers=4)
    got = engine.sweep_fsdp_contention(device="cpu", **kw)
    assert got == ref_engine.sweep_fsdp_contention(**kw)
    assert len(got) == 18


@pytest.mark.parametrize("o", [1.0, 4.0])
def test_multi_job_matches_reference(o):
    jobs = {"A": list(range(0, 32, 2)), "B": list(range(1, 32, 2))}
    got = engine.simulate_multi_job(topology.FatTree(k=8, n_hosts=32, oversubscription=o),
                                    jobs, layer_bytes=128e6, n_layers=3, device="cpu")
    want = ref_engine.simulate_multi_job(ref_topo.FatTree(k=8, n_hosts=32, oversubscription=o),
                                         jobs, layer_bytes=128e6, n_layers=3)
    assert_same(got, want, ctx=f"multi-job {o}")
    worst = max(got.slowdown.values())
    assert (worst < 1.01) if o == 1.0 else (worst > 1.3)
    with pytest.raises(ValueError, match="disjoint"):
        engine.simulate_multi_job(topology.FatTree(k=4), {"A": [0, 1], "B": [1, 2]},
                                  device="cpu")


def test_what_still_raises():
    with pytest.raises(ValueError, match="progress_engine"):
        engine.simulate_fsdp_step(p=8, progress_engine="smartnic", device="cpu")
    for cores, total in ((0, 108), (108, 108)):
        with pytest.raises(ValueError, match="host_cores"):
            engine.simulate_fsdp_step(p=8, progress_engine="host", host_cores=cores,
                                      host_total_cores=total, device="cpu")
    with pytest.raises(ValueError, match="loss"):
        engine.simulate_fsdp_step(p=8, loss=1e-3, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        sched_ir.build_fsdp_step(p=8, policy="ring")


def test_fsdp_entry_points_default_to_cuda():
    """Without a card the FSDP entry points raise rather than fall back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.simulate_fsdp_step(p=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.simulate_multi_job(topology.FatTree(k=4), {"A": [0, 1], "B": [2, 3]})


def test_routed_packet_and_fsdp_import_neither_jax_nor_repro():
    """A routed packet Broadcast and Allgather, a ring at packet fidelity,
    an FSDP step with its loss overlay (from a model config) and a
    multi-job run load no jax and no module of the JAX package."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "from repro_torch.configs.registry import get_model_config\n"
        "from repro_torch.core import engine, packet, sched_ir, simulator, topology\n"
        "t = topology.FatTree(k=8, n_hosts=16)\n"
        "b = simulator.simulate_broadcast(16, 1 << 16, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), topology=t, fidelity='packet',\n"
        "    loss=0.05, device='cpu')\n"
        "assert b.recovered and b.link_bytes\n"
        "a = packet.simulate_packet_allgather(16, 1 << 14, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), 4, topology=t, loss=0.05,\n"
        "    device='cpu')\n"
        "assert a.recovered and a.completed\n"
        "r = sched_ir.execute(sched_ir.build_ring_allgather(8, 1 << 20), fidelity='packet',\n"
        "    topology=t, loss=1e-3, device='cpu')\n"
        "assert r.bytes_recovery > 0\n"
        "s = engine.simulate_fsdp_step(get_model_config('smollm-135m'), p=16, policy='split',\n"
        "    topology=t, fidelity='packet', loss=1e-3, rng=np.random.default_rng(0),\n"
        "    device='cpu')\n"
        "assert 0 < s.bubble_fraction < 1\n"
        "m = engine.simulate_multi_job(topology.FatTree(k=8, n_hosts=32, oversubscription=4),\n"
        "    {'A': list(range(0, 32, 2)), 'B': list(range(1, 32, 2))}, layer_bytes=64e6,\n"
        "    n_layers=2, device='cpu')\n"
        "assert max(m.slowdown.values()) > 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]

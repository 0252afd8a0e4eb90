"""The port's training-run co-simulation (``core/train_sim.py``, its launch
facade, ``launch/analytic_costs.py``) against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_train_sim.py`` runs through both
packages on the same arguments and numpy generator seeds, with the
reference's chip (``TPU_V5E``): uniform and heterogeneous ``layers=``, the
degenerate mixes, analytic <= fluid <= packet over the policies and fabrics,
the pipeline composition, ``search=``, the facade and ``make_fabric``. Every
field must be equal exactly, a float's type included (``assert_same``), and
the generators' next draws too. ``H100`` is checked against the reference
given the same constants. The analytic cost model (``cell_cost``,
``collective_cost``, ``_fwd_flops``) equals the reference's on the registry's
train, prefill and decode shapes for every ported config.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import reduced as ref_reduced
from repro.configs.registry import get_model_config as ref_config
from repro.core import engine as ref_engine
from repro.core import train_sim as ref_ts
from repro.launch import analytic_costs as ref_ac
from repro_torch.configs import SHAPES, arch_names, get_model_config, reduced
from repro_torch.configs.registry import training_sweep_archs
from repro_torch.core import engine, train_sim
from repro_torch.core.train_sim import (H100, TPU_V5E, derive_layer_profiles, make_fabric,
                                        simulate_training_run)
from repro_torch.launch import analytic_costs as ac
from test_torch_allreduce import assert_same, fabrics
from test_torch_support import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAB = dict(jitter=0.0)
WK = dict(n_recv_workers=8)
MODEL = "smollm-135m"


def both(model=MODEL, **kw):
    """(port result, reference result) of ``simulate_training_run`` on the
    abstract fabric without jitter and the same arguments: ``model`` a name
    or a (port, reference) pair of configs."""
    t_model, r_model = (model, model) if isinstance(model, str) else model
    got = simulate_training_run(t_model, fabric=engine.FabricParams(**FAB), device="cpu", **kw)
    want = ref_ts.simulate_training_run(r_model, fabric=ref_engine.FabricParams(**FAB), **kw)
    return got, want


# ----------------------------- engine layers= generalization (bit-exact)


@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
@pytest.mark.parametrize("routed", [False, True], ids=["abstract", "routed"])
def test_uniform_layers_bit_exact_vs_legacy(policy, routed):
    """A uniform ``layers=`` profile reproduces the legacy parameterization
    bit-exact in the port, and both equal the reference's."""
    lb, p, n = 256e6, 16, 6
    fwd = 2.0 * (lb / 2) * 4096 / 200e12
    t_topo, r_topo = (fabrics("FatTree", k=8, n_hosts=16, oversubscription=4.0) if routed
                      else (None, None))
    kw = dict(p=p, policy=policy, hosts=range(p) if routed else None)
    legacy = engine.simulate_fsdp_step(n_layers=n, layer_bytes=lb, topology=t_topo,
                                       fabric=engine.FabricParams(**FAB), device="cpu", **kw)
    hetero = engine.simulate_fsdp_step(layers=[engine.LayerProfile(fwd, 2.0 * fwd, lb)] * n,
                                       topology=t_topo, fabric=engine.FabricParams(**FAB),
                                       device="cpu", **kw)
    want = ref_engine.simulate_fsdp_step(
        layers=[ref_engine.LayerProfile(fwd, 2.0 * fwd, lb)] * n, topology=r_topo,
        fabric=ref_engine.FabricParams(**FAB), **kw)
    for name in ("step_time", "bubble_fraction", "phase_times", "ag_bytes", "rs_bytes"):
        assert getattr(hetero, name) == getattr(legacy, name), name
    assert_same(hetero, want, f"{policy} routed={routed}")


def test_heterogeneous_layers_shift_the_timeline():
    lb, p, fwd = 128e6, 8, 1e-3
    shapes = {"uniform": [(fwd, 2 * fwd, lb)] * 4,
              "skewed": [(fwd / 2, fwd, lb / 2)] * 3 + [(fwd * 2.5, 5 * fwd, lb * 2.5)]}
    times = {}
    for name, rows in shapes.items():
        got = engine.simulate_fsdp_step(layers=[engine.LayerProfile(*r) for r in rows], p=p,
                                        fabric=engine.FabricParams(**FAB), policy="split",
                                        device="cpu")
        want = ref_engine.simulate_fsdp_step(
            layers=[ref_engine.LayerProfile(*r) for r in rows], p=p,
            fabric=ref_engine.FabricParams(**FAB), policy="split")
        assert_same(got, want, name)
        times[name] = got.step_time
    assert times["skewed"] > times["uniform"]


# -------------------------------------------- degenerate cases, bit-exact


def test_layer_profiles_match_reference():
    """``derive_layer_profiles`` for every sweep model, several dp, tp,
    grad_accum, remat and chips: every profile's three floats equal."""
    for arch in training_sweep_archs():
        for kw in (dict(dp=16), dict(dp=8, tp=2, grad_accum=4, remat="none"),
                   dict(dp=64, remat="dots", dtype_bytes=4.0)):
            for chip, ref_chip in ((TPU_V5E, ref_ts.TPU_V5E),
                                   (H100, ref_ts.ChipConstants(H100.name, H100.peak_flops,
                                                               H100.hbm_bw,
                                                               H100.opt_bytes_per_param))):
                got = derive_layer_profiles(arch, chip=chip, **kw)
                want = ref_ts.derive_layer_profiles(arch, chip=ref_chip, **kw)
                assert_same(got, want, f"{arch} {kw} {chip.name}")


def test_degenerate_mix_matches_simulate_fsdp_step_bit_exact():
    prof = derive_layer_profiles(MODEL, dp=16)
    for policy in ("naive", "split"):
        got, want = both(n_hosts=16, policy=policy)
        assert_same(got, want, policy)
        d = engine.simulate_fsdp_step(layers=prof, p=16, fabric=engine.FabricParams(**FAB),
                                      policy=policy, device="cpu")
        assert got.step_time == got.micro_time == d.step_time
        assert got.compute_time == d.compute_time
        assert got.bubble_fraction == d.bubble_fraction
        assert got.fsdp.step_time == d.step_time


def test_single_layer_model_matches_engine_bit_exact():
    cfg = reduced(get_model_config(MODEL), layers=1)
    ref_cfg = ref_reduced(ref_config(MODEL), layers=1)
    assert len(derive_layer_profiles(cfg, dp=8)) == 1
    got, want = both((cfg, ref_cfg), n_hosts=8, policy="split")
    assert_same(got, want)


@pytest.mark.parametrize("fidelity", ["analytic", "fluid", "packet"])
def test_single_host_is_pure_compute(fidelity):
    got, want = both(n_hosts=1, fidelity=fidelity)
    assert_same(got, want, fidelity)
    prof = derive_layer_profiles(MODEL, dp=1)
    assert got.step_time == sum(p.fwd_s for p in prof) + sum(p.bwd_s for p in prof)
    assert got.fsdp is None and got.bubble_fraction == 0.0 and 0.0 < got.mfu <= 1.0


# --------------------------------------------------- fidelity ordering

TOPO_ARGS = {"abstract": None,
             "fattree": (("FatTree",), dict(k=8, n_hosts=16, oversubscription=4.0)),
             "island": (("IslandFatTree", 4, 16), dict(island_size=4)),
             "torus": (("Torus2D", 4, 4), {})}


def both_topo(name, *, seed=None, **kw):
    """``both`` of ``MODEL`` on the fabric ``TOPO_ARGS[name]`` built by each
    package, with 8 receive workers."""
    t_topo, r_topo = (None, None) if TOPO_ARGS[name] is None else \
        fabrics(*TOPO_ARGS[name][0], **TOPO_ARGS[name][1])
    t_kw = dict(kw, fabric=engine.FabricParams(**FAB), workers=engine.WorkerParams(**WK))
    r_kw = dict(kw, fabric=ref_engine.FabricParams(**FAB), workers=ref_engine.WorkerParams(**WK))
    if seed is not None:
        t_kw["rng"], r_kw["rng"] = np.random.default_rng(seed), np.random.default_rng(seed)
    got = simulate_training_run(MODEL, topology=t_topo, device="cpu", **t_kw)
    want = ref_ts.simulate_training_run(MODEL, topology=r_topo, **r_kw)
    if seed is not None:
        assert t_kw["rng"].random() == r_kw["rng"].random()
    return got, want


@pytest.mark.parametrize("policy", ["naive", "mcast", "split"])
@pytest.mark.parametrize("topo", list(TOPO_ARGS))
def test_fidelity_ordering(policy, topo):
    """analytic <= fluid <= packet per (policy, fabric), each result equal to
    the reference's."""
    runs = {}
    for fidelity, extra in (("analytic", {}), ("fluid", {}),
                            ("packet", dict(loss=0.01, seed=0))):
        got, want = both_topo(topo, n_hosts=16, policy=policy, fidelity=fidelity, **extra)
        assert_same(got, want, f"{policy} {topo} {fidelity}")
        runs[fidelity] = got
    a, f, p = runs["analytic"], runs["fluid"], runs["packet"]
    assert a.step_time <= f.step_time + 1e-12 <= p.step_time + 1e-9
    for r in runs.values():
        assert 0.0 < r.mfu <= 1.0 and 0.0 <= r.bubble_fraction < 1.0


@pytest.mark.parametrize("arch", ["smollm-135m", "yi-9b", "granite-34b"])
def test_sweep_models_all_run(arch):
    assert arch in training_sweep_archs()
    lo, want_lo = both(arch, n_hosts=16)
    hi, want_hi = both(arch, n_hosts=64)
    assert_same(lo, want_lo, arch)
    assert_same(hi, want_hi, arch)
    assert hi.step_time < lo.step_time
    assert 0.0 < hi.mfu <= 1.0 and 0.0 < lo.mfu <= 1.0
    assert lo.n_devices == 16 and hi.n_devices == 64


# ------------------------------------------------ MFU under loss


@pytest.mark.parametrize("q_lo,q_hi", [(0.0, 0.0), (0.0, 0.004), (0.001, 0.013),
                                       (0.0075, 0.02), (0.011, 0.011)])
def test_mfu_monotone_non_increasing_in_loss(q_lo, q_hi):
    """The reference's property at fixed points: more loss never raises the
    MFU, and each run equals the reference's."""
    mfu = {}
    for q in (q_lo, q_hi):
        kw = dict(n_hosts=8, policy="naive")
        got, want = both(**kw) if q == 0.0 else both(fidelity="packet", loss=q, **kw)
        assert_same(got, want, q)
        mfu[q] = got.mfu
    assert 0.0 < mfu[q_hi] <= mfu[q_lo] <= 1.0


# --------------------------------------------- pipeline / search / facade


def test_pipeline_composition():
    ga, pp = 4, 2
    r, want = both(n_hosts=16, pp=pp, grad_accum=ga)
    assert_same(r, want)
    assert r.dp == 8
    assert r.step_time == (ga + pp - 1) * r.micro_time
    assert r.pipeline_bubble_fraction == (pp - 1) / (ga + pp - 1)
    prof = r.layer_profiles
    per = -(-len(prof) // pp)
    spans = [(lo, min(lo + per, len(prof))) for lo in range(0, len(prof), per)]
    heaviest = max(spans, key=lambda sp: sum(p.fwd_s + p.bwd_s for p in prof[sp[0]:sp[1]]))
    assert r.stage_span == heaviest
    r2, want2 = both(n_hosts=16, pp=pp, grad_accum=16)
    assert_same(r2, want2)
    assert r2.pipeline_bubble_fraction < r.pipeline_bubble_fraction
    big, want_big = both("granite-34b", n_hosts=64, pp=4, grad_accum=8, policy="split")
    assert_same(big, want_big)
    assert big.pipeline_bubble_fraction == (4 - 1) / (8 + 4 - 1)


def test_layer_profiles_are_heterogeneous():
    prof = derive_layer_profiles("yi-9b", dp=16)
    body = prof[1:-1]
    assert prof[0].layer_bytes > body[0].layer_bytes
    assert prof[-1].layer_bytes > body[0].layer_bytes
    assert prof[-1].fwd_s > body[0].fwd_s
    assert len({p.layer_bytes for p in body}) == 1


def test_search_hook_attaches_search_result():
    got, want = both(n_hosts=8, search=True)
    assert_same(got, want, skip=("wall_s",))
    assert got.searched is not None and got.searched.winner_time > 0
    assert got.searched_step_time is not None and got.searched_step_time > 0


def test_make_fabric_specs():
    from repro.core import topology as ref_topo
    assert make_fabric("abstract", 16) is None and make_fabric(None, 4) is None
    for spec, n, kw in (("fattree", 16, {}), ("fattree", 200, dict(oversubscription=2.0)),
                        ("island", 64, dict(island_size=8)), ("torus", 32, {}),
                        ("torus", 16, {})):
        got, want = make_fabric(spec, n, **kw), ref_ts.make_fabric(spec, n, **kw)
        assert type(got).__name__ == type(want).__name__
        assert vars(got).keys() == vars(want).keys()
        for k in ("k", "n_hosts", "island_size", "nx", "ny", "oversubscription"):
            assert getattr(got, k, None) == getattr(want, k, None), (spec, k)
    assert isinstance(ref_ts.make_fabric("fattree", 16), ref_topo.FatTree)
    ft = make_fabric("fattree", 16)
    assert ft.n_hosts == 16 and ft.k == 4
    with pytest.raises(AssertionError):
        make_fabric("torus", 24)
    with pytest.raises(ValueError):
        make_fabric("dragonfly", 16)


def test_launch_facade():
    from repro.launch import simulate_training_run as ref_launch
    from repro_torch.launch import simulate_training_run as launch_sim
    for spec in ("fattree", "island", "abstract"):
        got = launch_sim(MODEL, n_hosts=16, fabric=spec,
                         fabric_params=engine.FabricParams(**FAB), device="cpu")
        want = ref_launch(MODEL, n_hosts=16, fabric=spec,
                          fabric_params=ref_engine.FabricParams(**FAB))
        assert_same(got, want, spec)
        assert 0.0 < got.mfu <= 1.0
    got = launch_sim(MODEL, n_hosts=16, pp=2, grad_accum=2, fabric="fattree", device="cpu")
    assert_same(got, ref_launch(MODEL, n_hosts=16, pp=2, grad_accum=2, fabric="fattree"))
    with pytest.raises(TypeError):
        launch_sim(MODEL, n_hosts=16, topology=None, device="cpu")


def test_split_beats_naive_mfu_on_oversubscribed_fabric():
    runs = {}
    for policy in ("naive", "split"):
        got, want = both_topo("fattree", n_hosts=16, policy=policy)
        assert_same(got, want, policy)
        runs[policy] = got
    assert runs["split"].mfu > runs["naive"].mfu
    assert runs["split"].step_time < runs["naive"].step_time


def test_chip_constants_scale_compute():
    slow = train_sim.ChipConstants(name="half", peak_flops=TPU_V5E.peak_flops / 2,
                                   hbm_bw=TPU_V5E.hbm_bw)
    ref_slow = ref_ts.ChipConstants(name="half", peak_flops=TPU_V5E.peak_flops / 2,
                                    hbm_bw=TPU_V5E.hbm_bw)
    fast, want_fast = both(n_hosts=16)
    r_slow, want_slow = both(n_hosts=16, chip=slow)
    assert_same(r_slow, ref_ts.simulate_training_run(MODEL, n_hosts=16, chip=ref_slow,
                                                     fabric=ref_engine.FabricParams(**FAB)))
    assert r_slow.step_time > fast.step_time
    assert TPU_V5E.peak_flops == 197e12 and TPU_V5E.hbm_bw == 819e9
    assert train_sim.ChipConstants() == TPU_V5E


def test_h100_constants_match_reference_arithmetic():
    """``chip=H100`` is the H100 SXM's figures; the result equals the
    reference's given the same constants, for every sweep model at 64
    hosts (phase 5g's runs) and on a routed fabric."""
    assert (H100.name, H100.peak_flops, H100.hbm_bw, H100.opt_bytes_per_param) == \
        ("h100_sxm", 989e12, 3.35e12, 8.0)
    ref_h100 = ref_ts.ChipConstants("h100_sxm", 989e12, 3.35e12, 8.0)
    for arch in training_sweep_archs():
        got = simulate_training_run(arch, n_hosts=64, policy="split",
                                    fabric=engine.FabricParams(**FAB), chip=H100, device="cpu")
        want = ref_ts.simulate_training_run(arch, n_hosts=64, policy="split",
                                            fabric=ref_engine.FabricParams(**FAB),
                                            chip=ref_h100)
        assert_same(got, want, arch)
        v5e = simulate_training_run(arch, n_hosts=64, policy="split",
                                    fabric=engine.FabricParams(**FAB), device="cpu")
        assert got.compute_time < v5e.compute_time
    got, want = both_topo("fattree", n_hosts=16, policy="mcast", chip=H100)
    assert_same(got, ref_ts.simulate_training_run(
        MODEL, n_hosts=16, policy="mcast", chip=ref_h100,
        topology=fabrics("FatTree", k=8, n_hosts=16, oversubscription=4.0)[1],
        fabric=ref_engine.FabricParams(**FAB), workers=ref_engine.WorkerParams(**WK)))


def test_sweep_training_runs_matches_reference():
    kw = dict(policies=("naive", "mcast", "split"))
    got = train_sim.sweep_training_runs(["smollm-135m", "yi-9b"], (16, 64), device="cpu",
                                        fabric=engine.FabricParams(**FAB), **kw)
    want = ref_ts.sweep_training_runs(["smollm-135m", "yi-9b"], (16, 64),
                                      fabric=ref_engine.FabricParams(**FAB), **kw)
    assert_same(got, want)


def test_training_run_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_training_run(MODEL, n_hosts=16)


# ------------------------------------------------------ the analytic costs


def _cfg_pairs():
    return [(a, get_model_config(a), ref_config(a)) for a in arch_names()]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_cell_cost_matches_reference(shape):
    """``cell_cost``, ``collective_cost`` and ``_fwd_flops`` at the
    registry's train, prefill and decode shapes, for every ported config,
    reduced too, over remat, tp, dp, serve_replicated and the int8 cache's
    byte count: every float equal."""
    s, rs = SHAPES[shape], REF_SHAPES[shape]
    for arch, cfg, ref_cfg in _cfg_pairs():
        for c, rc in ((cfg, ref_cfg), (reduced(cfg), ref_reduced(ref_cfg))):
            for kw in (dict(), dict(remat="none", tp=4), dict(serve_replicated=True,
                                                              opt_bytes_per_param=12.0)):
                got = ac.cell_cost(c, s, 256, **kw)
                want = ref_ac.cell_cost(rc, rs, 256, **kw)
                assert_same(got, want, f"{arch} {shape} {kw}")
                assert got.useful_ratio == want.useful_ratio
            for kw in (dict(dp=16, tp=16), dict(dp=8, tp=1, remat="none", grad_accum=4),
                       dict(dp=32, tp=2, ep_crossing_factor=0.5, serve_replicated=True),
                       dict(dp=1, tp=1)):
                got = ac.collective_cost(c, s, **kw)
                want = ref_ac.collective_cost(rc, rs, **kw)
                assert_same(got, want, f"{arch} {shape} {kw}")
                assert got.total == want.total
            for b in (1, s.global_batch):
                assert ac._fwd_flops(c, s.seq_len, b) == ref_ac._fwd_flops(rc, s.seq_len, b)
            assert ac._cache_bytes(c, s.seq_len, 8) == ref_ac._cache_bytes(rc, s.seq_len, 8)


def test_cell_cost_int8_cache_bytes():
    from dataclasses import replace as dc_replace
    for arch, cfg, ref_cfg in _cfg_pairs():
        c, rc = dc_replace(cfg, kv_cache_dtype="int8"), dc_replace(ref_cfg, kv_cache_dtype="int8")
        assert ac._cache_bytes(c, 32_768, 128) == ref_ac._cache_bytes(rc, 32_768, 128)

"""The port's MoE family on a physical ``model`` axis against the JAX
package's GSPMD placement: the experts split over ``model`` (EP), each
rank's dp gather leaving it its tp rank's E / tp experts, routed globally.

- ``moe_apply`` in-process against ``repro.models.moe.moe_apply`` on one
  device, the port on ``(data=2, model=4)`` and ``(data=4, model=2)`` with
  the output on every position and on the sequence chunks: the output
  within 1e-5, the aux losses within 1e-6, the drop fraction bitwise.
- Reduced deepseek-moe-16b and moonshot-v1-16b-a3b (f32) served and
  trained on both meshes, and a reduced MoE of 6 experts (no split over
  ``model`` at tp = 4, three a tp rank at tp = 2), against
  ``jit_prefill_step``, ``jit_decode_step`` and ``jit_train_step`` (xla) on
  the same Auto mesh, in one subprocess with 8 fake CPU devices
  (``run_reference``), started first: prefill logits and caches within
  1e-5 in every mode and with ``serve_params_replicated``, bitwise across
  the modes; 5 decode steps from the prefill's cache, logits within 1e-4
  and the same tokens; 3 training steps in every mode, loss within 1e-5,
  grad_norm within 1e-4 relative, ``moe_aux`` and ``moe_zloss`` within
  1e-6, ``moe_drop_frac`` bitwise, every parameter within 1e-5.
- A rank's gathered expert leaf holds E / tp experts (E where E does not
  split), one copy a tp rank in the serving layout.
- The #1, #1b and #3 launches of a prefill, a decode step and a train step,
  counted on the CPU, equal ``chip_smoke.tpf_launches``.
"""
import dataclasses
import importlib.util
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.models import moe as ref_moe
from repro_torch import bridge
from repro_torch.configs import MeshConfig, ShapeConfig, get_model_config, reduced
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import moe
from repro_torch.runtime.train_loop import make_ctx
from repro_torch.sharding import tp as TP
from repro_torch.sharding.ctx import from_ranks, maybe_gather_params, to_ranks, use_ctx
from repro_torch.sharding.fsdp import replicate_over_dp
from repro_torch.sharding.specs import dp_axes
from test_torch_support import (REPO, TP_FAMILY_BODY, TP_MESHES, TP_MODES,  # noqa: F401
                                check_tpf_launches, flatten, one_torch_thread,
                                run_reference, serve_run, tp_family_inputs, tp_serve_port,
                                tp_train_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = {"deepseek": ("deepseek-moe-16b", None), "moonshot": ("moonshot-v1-16b-a3b", None),
         "moe6": ("deepseek-moe-16b", 6)}       # 6 experts: no split over model at tp = 4
B, S, CACHE, NEW = 8, 16, 24, 5      # a cache of 24 positions splits over tp = 2 and 4
TRAIN_B, TRAIN_S, STEPS = 8, 32, 3
CASES = {f"{a}/{m}": {"arch": ARCHS[a][0], "layers": None, "experts": ARCHS[a][1],
                      "mesh": TP_MESHES[m], "inputs": ["tokens"], "batch": ["tokens", "targets"],
                      "serve": (B, S, CACHE, NEW), "train": (TRAIN_B, TRAIN_S, STEPS)}
         for a in ARCHS for m in TP_MESHES}
T_B, T_S = 8, 4                      # moe_apply's tokens: T = 32


def cfg_of(name: str):
    arch, experts = ARCHS[name.split("/")[0]]
    cfg = reduced(get_model_config(arch))
    return cfg if not experts else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_routed_experts=experts))


def mesh_of(name: str) -> StackedMesh:
    d, m = TP_MESHES[name.split("/")[1]]
    return StackedMesh(data=d, model=m)


def tree_of(name: str, seed: int) -> dict:
    """A reduced MoE tree with its norm scales drawn too."""
    tree = bridge.random_params(cfg_of(name), seed)
    rng = np.random.default_rng(seed + 1)
    for holder, key in ((tree, "final_ln"), (tree["blocks"], "ln1"), (tree["blocks"], "ln2")):
        holder[key] = (0.1 * rng.standard_normal(holder[key].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def case():
    """The reference's runs in one subprocess, started first; the port's
    beside it."""
    inputs, port_in = {}, {}
    for i, name in enumerate(CASES):
        cfg = cfg_of(name)
        tokens = torch.from_numpy(np.random.default_rng(i).integers(0, cfg.vocab_size, (B, S)))
        pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", TRAIN_S, TRAIN_B), device="cpu")
        batches = [pipe.next_batch(j) for j in range(STEPS)]
        trees = (tree_of(name, 10 + i), tree_of(name, 30 + i))
        port_in[name] = (trees, {"tokens": tokens}, batches)
        inputs.update(tp_family_inputs(name, CASES[name], trees[0], trees[1],
                                       {"tokens": tokens}, batches))
    body = f"CASES = {CASES!r}\n" + TP_FAMILY_BODY
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, body, inputs)
        port = {}
        for name, (trees, batch, batches) in port_in.items():
            cfg, mesh = cfg_of(name), mesh_of(name)
            port[name] = {"serve": tp_serve_port(cfg, trees[0], mesh, batch, CACHE, NEW),
                          "train": {mode: tp_train_port(cfg, trees[1], mesh, batches, mode)
                                    for mode in TP_MODES}}
        return dict(ref=ref.result(), port=port)


# ------------------------------------------------------------- moe_apply


def _layer(name: str, mesh: StackedMesh, mode: str):
    """Layer 0's MoE weights gathered over dp as a prefill gathers them
    (every rank's copy, its ``model`` split kept), and the layer's numpy
    leaves."""
    cfg = cfg_of(name)
    tree = bridge.random_params(cfg, 5)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    layer = {k: v._replace(local=v.local[:, 0], spec=v.spec[1:])
             for k, v in flatten(params["blocks"]["moe"]).items()}
    nested = {}
    for key, leaf in layer.items():
        node = nested
        *parents, last = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    ctx = make_ctx(serve_run(cfg, mode, T_B, T_S), mesh)
    with use_ctx(ctx):
        p = maybe_gather_params(nested)
    ref = {k: (v[0] if not isinstance(v, dict) else {n: a[0] for n, a in v.items()})
           for k, v in tree["blocks"]["moe"].items()}
    return ctx, p, ref


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_apply_matches_jax(arch, mesh_name, sp):
    """``moe_apply`` at tp > 1 on its gathered copies against the
    reference's on one device: global routing over every token of the
    batch in its (b, s) order, whatever rank holds them; the output on
    every position, or on each rank's sequence chunk (``sp``)."""
    name = f"{arch}/{mesh_name}"
    cfg, mesh = cfg_of(name), mesh_of(name)
    ctx, p, ref_p = _layer(name, mesh, "mcast")
    x = np.random.default_rng(7).standard_normal((T_B, T_S, cfg.d_model)).astype(np.float32)
    ref_cfg = ref_reduced(ref_model_config(ARCHS[arch][0]))
    if ARCHS[arch][1]:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, n_routed_experts=ARCHS[arch][1]))
    want, want_m = ref_moe.moe_apply(jax.tree.map(jnp.asarray, ref_p), jnp.asarray(x), ref_cfg)
    with use_ctx(ctx):
        out, m = moe.moe_apply(p, to_ranks(torch.from_numpy(x), mesh.n_ranks), cfg, sp=sp)
        if sp:
            assert out.shape[2] == T_S // mesh.tp
            out = TP.gather(out, 2)
        out = from_ranks(out)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for key in ("moe_aux", "moe_zloss"):
        assert abs(float(m[key]) - float(want_m[key])) <= 1e-6, key
    assert float(m["moe_drop_frac"]) == float(want_m["moe_drop_frac"])
    assert float(m["moe_drop_frac"]) > 0


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_gathered_expert_leaf_holds_its_tp_ranks_experts(arch, mesh_name):
    """After the dp gather a rank's copy of an expert leaf is (E / tp, ...):
    its tp rank's experts, E / tp the bytes of tp = 1 (E where E does not
    divide, as the reference replicates it); the serving layout keeps one
    copy a tp rank, (tp, E / tp, ...); the router is whole everywhere."""
    name = f"{arch}/{mesh_name}"
    cfg, mesh = cfg_of(name), mesh_of(name)
    e, d, f = cfg.moe.n_routed_experts, cfg.d_model, cfg.moe.d_ff_expert
    el = e // mesh.tp if e % mesh.tp == 0 else e
    _, p, ref_p = _layer(name, mesh, "mcast")
    for key in ("w_gate", "w_up"):
        assert tuple(p[key].shape) == (mesh.n_ranks, el, d, f), key
    assert tuple(p["w_down"].shape) == (mesh.n_ranks, el, f, d)
    assert tuple(p["router"].shape) == (mesh.n_ranks, d, e)
    for r in range(mesh.n_ranks):   # rank r's copy: tp rank r % tp's experts
        lo = (r % mesh.tp) * el if el < e else 0
        np.testing.assert_array_equal(p["w_gate"][r].numpy(), ref_p["w_gate"][lo:lo + el])
    params = bridge.to_torch(bridge.random_params(cfg, 5), mesh, MeshConfig(),
                             dtype=torch.float32, device="cpu")
    served = replicate_over_dp(params, mesh, dp_axes(MeshConfig()), lambda path, leaf: True)
    copies = mesh.tp if el < e else mesh.n_ranks
    assert tuple(served["blocks"]["moe"]["w_gate"].local.shape) == (copies, cfg.num_layers,
                                                                     el, d, f)


def test_expert_blocks_split_each_tp_ranks_experts_over_its_dp_ranks():
    """Expert e lies on tp rank e // (E / tp), owned by one of its dp ranks:
    64 experts on (2, 4) give each of the 8 ranks 8, rank d * 4 + m the
    experts 16 m + 8 d .. 16 m + 8 d + 7; on the serving layout's tp copies
    copy m; unsplit (E' = E), the R copies share them out."""
    w = torch.zeros(8, 16, 1)
    copy, slot = moe.expert_blocks(64, w, 8)
    e = torch.arange(64)
    assert torch.equal(slot, e % 16)
    assert torch.equal(copy, (e % 16) // 8 * 4 + e // 16)
    assert torch.bincount(copy).tolist() == [8] * 8
    copy, slot = moe.expert_blocks(64, torch.zeros(4, 16, 1), 8)
    assert torch.equal(copy, e // 16) and torch.equal(slot, e % 16)
    copy, slot = moe.expert_blocks(6, torch.zeros(8, 6, 1), 8)
    assert copy.tolist() == moe.expert_owners(6, 8, "cpu").tolist()
    assert torch.equal(slot, torch.arange(6))


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(case, name):
    """Last-position logits and the KV cache within 1e-5 of the reference's
    prefill on the same Auto mesh, in every mode and with the weights
    replicated over dp; the modes' logits and caches bitwise equal."""
    ref, port = case["ref"], case["port"][name]["serve"]
    base_logits, base_cache = port["xla"]
    for mode in TP_MODES + ["repl"]:
        logits, cache = port[mode]
        np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=1e-5, rtol=0,
                                   err_msg=mode)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(), ref[f"{name}/cache/{key}"],
                                       atol=1e-5, rtol=0, err_msg=f"{mode} {key}")
        if mode != "repl":
            assert torch.equal(logits, base_logits), mode
            assert all(torch.equal(cache[k], base_cache[k]) for k in cache), mode


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax(case, name):
    """5 decode steps (no drops) from the prefill's cache: logits within
    1e-4 of the reference's decode steps, the same tokens."""
    ref = case["ref"]
    logits, tokens = case["port"][name]["serve"]["decode"]
    np.testing.assert_array_equal(tokens.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(logits.numpy(), ref[name + "/decode/logits"], atol=1e-4, rtol=0)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("mode", TP_MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(case, name, mode):
    """3 steps against ``jit_train_step`` on the same Auto mesh: loss within
    1e-5 and grad_norm within 1e-4, relative; ``moe_aux`` and ``moe_zloss``
    within 1e-6 and ``moe_drop_frac`` bitwise; then every parameter within
    1e-5."""
    ref = case["ref"]
    metrics, params = case["port"][name]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{name}/mesh/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{name}/mesh/grad_norm{i}"]),
                                               rel=1e-4), i
        for key in ("moe_aux", "moe_zloss"):
            assert abs(m[key] - float(ref[f"{name}/mesh/{key}{i}"])) <= 1e-6, (i, key)
        assert np.float32(m["moe_drop_frac"]) == ref[f"{name}/mesh/moe_drop_frac{i}"], i
        assert m["moe_drop_frac"] > 0
    for key, a in params.items():
        np.testing.assert_allclose(a, ref[f"{name}/mesh/params/{key}"], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_train_modes_agree_bitwise_on_the_first_loss(case, name):
    runs = case["port"][name]["train"]
    assert len({runs[mode][0][0]["loss"] for mode in TP_MODES}) == 1


# ------------------------------------------------------------ launches


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", f"{REPO}/chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# launches of a prefill, a decode step and a train step: the reduced config
# (2 heads: whole on every tp rank at tp = 4, split at tp = 2) and one with
# deepseek-moe-16b's head plan (16 heads and kv heads: split at both)
VARIANTS = {"reduced": {}, "heads": dict(num_heads=16, num_kv_heads=16, head_dim=4)}


@pytest.mark.parametrize("mode", ["xla", "mcast"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ["deepseek", "moe6"])
@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
def test_launches_match_chip_smoke(monkeypatch, mesh_name, arch, variant, mode):
    """The CPU spy counts of #1, #1b and #3 (router f32) of the reduced
    MoE in bf16 on each mesh equal ``chip_smoke.tpf_launches``, the counts
    phases 3i and 4i assert, and the products' shapes
    ``tpf_matmul_cases``."""
    cfg = dataclasses.replace(cfg_of(f"{arch}/{mesh_name}"), param_dtype="bfloat16",
                              compute_dtype="bfloat16", **VARIANTS[variant])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    check_tpf_launches(monkeypatch, _chip_smoke(), cfg, mesh_of(f"{arch}/{mesh_name}"), mode,
                       {"tokens": tokens}, ShapeConfig("t", "train", TRAIN_S, 2 * TRAIN_B))

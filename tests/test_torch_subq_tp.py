"""The port's sub-quadratic families on a physical ``model`` axis against
the JAX package's GSPMD placement: rwkv6-7b with its heads split over
``model`` (the LoRAs whole, the decay, the bonus and the group norm taken
per rank; the channel mix's value reduce-scattered on d_model before the
receptance multiplies it), and recurrentgemma-9b with its LRU width split
(the gates' input gathered whole; attention's 2 heads whole at tp = 4 and
split at tp = 2, over one kv head).

Reduced f32 configs (the hybrid served at 5 layers, window 32, and trained
at 3) on ``(data=2, model=4)`` and ``(data=4, model=2)``, against
``jit_prefill_step``, ``jit_decode_step`` and ``jit_train_step`` (xla) on
the same Auto mesh, in one subprocess with 8 fake CPU devices
(``run_reference``), started first; the port's runs go on beside it:

- prefill logits and caches (the rwkv states, the hybrid's rec states and
  window) within 1e-5 (rwkv's WKV state, up to 10 in size, within 1e-4, as
  ``tests/test_torch_subquadratic.py`` holds it) in every mode and with
  ``serve_params_replicated``,
  bitwise across the modes; 5 decode steps from the prefill's cache (the
  hybrid's 40-token prompt past its window, handed to the rings by
  position), logits within 1e-4 and the same tokens;
- training steps in every mode (3 for the hybrid; 2 for rwkv, at
  ``tests/test_torch_subquadratic.py``'s draw: tree seed 20, batch 8 x 32):
  loss within 1e-5 of the mesh step; grad_norm within 1e-4, relative, and
  every parameter within 1e-5, of the mesh step for the hybrid and of the
  reference's one-device step for rwkv (ROADMAP §3: rwkv's grad norm after
  the first step is ill-conditioned in the reference itself);
- the #1, #1b and #3 launches counted on the CPU against
  ``chip_smoke.tpf_launches``.
"""
import dataclasses
import importlib.util
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import ShapeConfig, get_model_config, reduced
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from test_torch_support import (REPO, TP_FAMILY_BODY, TP_MESHES, TP_MODES,  # noqa: F401
                                check_tpf_launches, flatten, one_torch_thread,
                                run_reference, tp_family_inputs, tp_serve_port,
                                tp_train_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = {"rwkv": "rwkv6-7b", "hybrid": "recurrentgemma-9b"}
SERVE_LAYERS = {"rwkv": None, "hybrid": 5}
# serving: batch, prompt, cache length, decode steps; the hybrid's prompt is
# longer than its window (32): the decode rings take its last 32 positions
SERVE = {"rwkv": (8, 16, 24, 5), "hybrid": (8, 40, 48, 5)}
# training: batch, length, steps; rwkv's 2 steps are the draw at which
# ``tests/test_torch_subquadratic.py`` holds its grad norm against the
# one-device step (ROADMAP §3; at a third step the reference's own meshes
# spread by 1.1e-4 relative)
TRAIN = {"rwkv": (8, 32, 2), "hybrid": (8, 32, 3)}
CASES = {f"{a}/{m}": {"arch": ARCHS[a], "layers": SERVE_LAYERS[a], "train_layers": None,
                      "experts": None, "mesh": TP_MESHES[m], "inputs": ["tokens"],
                      "batch": ["tokens", "targets"], "serve": SERVE[a], "train": TRAIN[a],
                      "single": a == "rwkv" and m == "2x4"}
         for a in ARCHS for m in TP_MESHES}
# the rwkv WKV state (|S| up to 10) within 1e-4, as
# ``tests/test_torch_subquadratic.py`` holds it: its chunked f32 sums run in
# another order
CACHE_TOL = {"wkv": 1e-4}
# ``tests/test_torch_subquadratic.py``'s trees: the leaves that are zeros or
# ones at init drawn too, serving seeds 10 + i, training 20 + i
_VECTORS = ("ln", "ln1", "ln2", "final_ln", "conv_b", "lru_a_bias", "lru_x_bias",
            "ln_x_bias")


def serve_cfg(arch: str):
    return reduced(get_model_config(ARCHS[arch]), layers=SERVE_LAYERS[arch])


def train_cfg(arch: str):
    return reduced(get_model_config(ARCHS[arch]))


def tree_of(cfg, seed: int) -> dict:
    tree = bridge.random_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in _VECTORS:
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    fill(tree)
    return tree


def mesh_of(name: str) -> StackedMesh:
    d, m = TP_MESHES[name.split("/")[1]]
    return StackedMesh(data=d, model=m)


@pytest.fixture(scope="module")
def case():
    """The reference's runs in one subprocess, started first; the port's
    beside it. Both meshes of a family serve and train the same trees."""
    inputs, port_in = {}, {}
    for i, arch in enumerate(ARCHS):
        trees = (tree_of(serve_cfg(arch), 10 + i), tree_of(train_cfg(arch), 20 + i))
        b, s = SERVE[arch][:2]
        tokens = torch.from_numpy(np.random.default_rng(i).integers(0, 256, (b, s)))
        tb, ts, steps = TRAIN[arch]
        pipe = SyntheticPipeline(train_cfg(arch), ShapeConfig("t", "train", ts, tb),
                                 device="cpu")
        batches = [pipe.next_batch(j) for j in range(steps)]
        for m in TP_MESHES:
            name = f"{arch}/{m}"
            port_in[name] = (trees, {"tokens": tokens}, batches)
            inputs.update(tp_family_inputs(name, CASES[name], trees[0], trees[1],
                                           {"tokens": tokens}, batches))
    body = f"CASES = {CASES!r}\n" + TP_FAMILY_BODY
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, body, inputs)
        port = {}
        for name, (trees, batch, batches) in port_in.items():
            arch, mesh = name.split("/")[0], mesh_of(name)
            _, _, cache_len, steps = SERVE[arch]
            port[name] = {
                "serve": tp_serve_port(serve_cfg(arch), trees[0], mesh, batch, cache_len, steps),
                "train": {mode: tp_train_port(train_cfg(arch), trees[1], mesh, batches, mode)
                          for mode in TP_MODES}}
        return dict(ref=ref.result(), port=port)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(case, name):
    """Last-position logits and every cache leaf within 1e-5 of the
    reference's prefill on the same Auto mesh, in every mode and with the
    weights replicated over dp; the modes' logits and caches bitwise
    equal."""
    ref, port = case["ref"], case["port"][name]["serve"]
    want = {k[len(name + "/cache/"):]: v for k, v in ref.items()
            if k.startswith(name + "/cache/")}
    base_logits, base_cache = port["xla"]
    for mode in TP_MODES + ["repl"]:
        logits, cache = port[mode]
        np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=1e-5, rtol=0,
                                   err_msg=mode)
        got = {k: v for k, v in flatten(cache).items() if v is not None}
        assert sorted(got) == sorted(want), mode
        for key, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[key], rtol=0,
                                       atol=CACHE_TOL.get(key.split("/")[-1], 1e-5),
                                       err_msg=f"{mode} {key}")
        if mode != "repl":
            assert torch.equal(logits, base_logits), mode
            base = flatten(base_cache)
            assert all(torch.equal(a, base[k]) for k, a in got.items()), mode


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax(case, name):
    """5 decode steps from the prefill's cache (the rwkv states as they are;
    the hybrid's window written into its rings by position): logits within
    1e-4 of the reference's decode steps, the same tokens."""
    ref = case["ref"]
    logits, tokens = case["port"][name]["serve"]["decode"]
    np.testing.assert_array_equal(tokens.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(logits.numpy(), ref[name + "/decode/logits"], atol=1e-4, rtol=0)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("mode", TP_MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(case, name, mode):
    """3 steps: loss within 1e-5, relative, of ``jit_train_step`` on the same
    Auto mesh; grad_norm within 1e-4, relative, and every parameter within
    1e-5 of the mesh step (hybrid) or of the reference's one-device step
    (rwkv, ROADMAP §3)."""
    ref = case["ref"]
    arch = name.split("/")[0]
    yard = f"{arch}/2x4/single" if arch == "rwkv" else f"{name}/mesh"
    metrics, params = case["port"][name]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{name}/mesh/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{yard}/grad_norm{i}"]), rel=1e-4), i
    for key, a in params.items():
        np.testing.assert_allclose(a, ref[f"{yard}/params/{key}"], atol=1e-5, rtol=0,
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


# launches of a prefill, a decode step and a train step: the reduced configs
# and rwkv with 2 heads of 32 (its time mix gathered whole at tp = 4),
# the hybrid with recurrentgemma-9b's head plan (16 heads on one kv head)
VARIANTS = {"rwkv/reduced": ("rwkv", {}),
            "rwkv/2heads": ("rwkv", dict(num_heads=2, num_kv_heads=2, head_dim=32)),
            "hybrid/reduced": ("hybrid", {}),
            "hybrid/heads": ("hybrid", dict(num_heads=16, num_kv_heads=1, head_dim=8))}


@pytest.mark.parametrize("mode", ["xla", "mcast"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
def test_launches_match_chip_smoke(monkeypatch, mesh_name, variant, mode):
    """The CPU spy counts of #1, #1b and #3 (the RG-LRU's gates f32) of the
    reduced configs in bf16 (the hybrid at 5 layers: every layer kind) on
    each mesh equal ``chip_smoke.tpf_launches``, the counts phases 3i and
    4i assert, and the products' shapes ``tpf_matmul_cases``."""
    arch, kw = VARIANTS[variant]
    cfg = dataclasses.replace(serve_cfg(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16", attn_q_block=512, attn_kv_block=1024,
                              **kw)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)))
    check_tpf_launches(monkeypatch, _chip_smoke(), cfg, mesh_of(f"{arch}/{mesh_name}"), mode,
                       {"tokens": tokens}, ShapeConfig("t", "train", 32, 16))

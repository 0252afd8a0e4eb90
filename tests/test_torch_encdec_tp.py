"""The port's encoder-decoder (whisper-base) on a physical ``model`` axis
against the JAX package's GSPMD placement: the encoder's and the decoder's
self- and cross-attention heads split over ``model`` where they divide
(whole on every tp rank where not: the reduced config's 2 heads at tp = 4),
the gelu MLP's hidden units split, both streams sequence-parallel where
their lengths divide, the positions added to the whole stream before it is
split, the cross K/V cache read by its sequence shards in decode.

The reduced f32 config (2 + 2 layers) on ``(data=2, model=4)`` and
``(data=4, model=2)``, against ``jit_prefill_step``, ``jit_decode_step`` and
``jit_train_step`` (xla) on the same Auto mesh, in one subprocess with 8
fake CPU devices (``run_reference``), started first; the port's runs go on
beside it. Every batch is made here and handed to both:

- prefill logits and the cache {k, v, xk, xv} within 1e-5 in every mode and
  with ``serve_params_replicated``, bitwise across the modes; 5 decode
  steps from the prefill's cache (k and v padded, xk and xv as they are),
  logits within 1e-4 and the same tokens;
- 3 training steps in every mode: loss within 1e-5 and grad_norm within
  1e-4, relative, every parameter within 1e-5;
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

ARCH = "whisper-base"
# serving: batch, prompt tokens, cache length, decode steps; 24 frames and a
# cache of 24 positions split over tp = 2 and 4
B, S, S_ENC, CACHE, NEW = 8, 16, 24, 24, 5
TRAIN_B, TRAIN_S, STEPS = 8, 32, 3
CASES = {f"whisper/{m}": {"arch": ARCH, "layers": None, "experts": None,
                          "mesh": TP_MESHES[m], "inputs": ["frames", "tokens"],
                          "batch": ["frames", "tokens", "targets"], "serve": (B, S, CACHE, NEW),
                          "train": (TRAIN_B, TRAIN_S, STEPS)}
         for m in TP_MESHES}
_VECTORS = ("ln1", "ln2", "ln_x", "enc_ln", "final_ln")


def cfg_of():
    return reduced(get_model_config(ARCH))


def tree_of(seed: int) -> dict:
    """The reduced tree with its norm scales drawn too."""
    tree = bridge.random_params(cfg_of(), seed)
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
    beside it. Both meshes serve and train the same trees and batches."""
    cfg = cfg_of()
    rng = np.random.default_rng(4)
    batch = {"frames": torch.from_numpy((rng.standard_normal((B, S_ENC, cfg.d_model))
                                         * 0.02).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", "train", TRAIN_S, TRAIN_B), device="cpu")
    batches = [pipe.next_batch(j) for j in range(STEPS)]
    trees = (tree_of(12), tree_of(22))
    inputs = {}
    for name in CASES:
        inputs.update(tp_family_inputs(name, CASES[name], trees[0], trees[1], batch, batches))
    body = f"CASES = {CASES!r}\n" + TP_FAMILY_BODY
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, body, inputs)
        port = {name: {"serve": tp_serve_port(cfg, trees[0], mesh_of(name), batch, CACHE, NEW),
                       "train": {mode: tp_train_port(cfg, trees[1], mesh_of(name), batches,
                                                     mode) for mode in TP_MODES}}
                for name in CASES}
        return dict(ref=ref.result(), port=port)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(case, name):
    """Last-position logits and the cache {k, v, xk, xv} within 1e-5 of the
    reference's prefill on the same Auto mesh, in every mode and with the
    weights replicated over dp; the modes' logits and caches bitwise
    equal."""
    ref, port = case["ref"], case["port"][name]["serve"]
    base_logits, base_cache = port["xla"]
    for mode in TP_MODES + ["repl"]:
        logits, cache = port[mode]
        np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=1e-5, rtol=0,
                                   err_msg=mode)
        assert sorted(cache) == ["k", "v", "xk", "xv"]
        for key, a in cache.items():
            np.testing.assert_allclose(a.numpy(), ref[f"{name}/cache/{key}"], atol=1e-5,
                                       rtol=0, err_msg=f"{mode} {key}")
        if mode != "repl":
            assert torch.equal(logits, base_logits), mode
            assert all(torch.equal(a, base_cache[k]) for k, a in cache.items()), mode


@pytest.mark.parametrize("name", list(CASES))
def test_decode_matches_jax(case, name):
    """5 decode steps from the prefill's cache: the self-attention's written
    at each position, the cross K/V read by its sequence shards: logits
    within 1e-4 of the reference's decode steps, the same tokens."""
    ref = case["ref"]
    logits, tokens = case["port"][name]["serve"]["decode"]
    np.testing.assert_array_equal(tokens.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(logits.numpy(), ref[name + "/decode/logits"], atol=1e-4, rtol=0)


# ------------------------------------------------------------ training


@pytest.mark.parametrize("mode", TP_MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(case, name, mode):
    """3 steps against ``jit_train_step`` on the same Auto mesh: loss within
    1e-5 and grad_norm within 1e-4, relative; every parameter within
    1e-5."""
    ref = case["ref"]
    metrics, params = case["port"][name]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{name}/mesh/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{name}/mesh/grad_norm{i}"]),
                                               rel=1e-4), i
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
# (2 heads) and one with whisper-base's head plan (8 heads), at an odd vocab
# (259) as its 51,865 (the head on the wmma kernel, not split over model)
VARIANTS = {"reduced": {}, "heads": dict(num_heads=8, num_kv_heads=8, head_dim=8)}


@pytest.mark.parametrize("mode", ["xla", "mcast"])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
def test_launches_match_chip_smoke(monkeypatch, mesh_name, variant, mode):
    """The CPU spy counts of #1, #1b and #3 (the head's wmma) of the reduced
    whisper in bf16 on each mesh, 16 frames and 16 tokens, equal
    ``chip_smoke.tpf_launches``, the counts phases 3i and 4i assert, and
    the products' shapes ``tpf_matmul_cases``."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(cfg_of(), param_dtype="bfloat16", compute_dtype="bfloat16",
                              attn_q_block=512, attn_kv_block=1024, vocab_size=259,
                              **VARIANTS[variant])
    batch = cs._tpf_batch(cfg, 16, torch.Generator().manual_seed(0), "cpu")
    check_tpf_launches(monkeypatch, cs, cfg, mesh_of(f"whisper/{mesh_name}"), mode, batch,
                       ShapeConfig("t", "train", 32, 16))

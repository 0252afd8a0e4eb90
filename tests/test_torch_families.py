"""The port's last three architectures against the JAX package's:
phi-3-vision-4.2b (the ``vlm`` family: the dense stack with ``patch_proj``
and the patches ahead of the tokens), whisper-base (the ``encdec``
family, ``models/encdec.py``) and moonshot-v1-16b-a3b (a config of the
ported MoE family), reduced and in f32.

- The pieces in-process on one device: the patch stream, ``_posenc``,
  ``encode``, ``_dec_block`` with its cross-attention and
  ``encdec_decode_step``.
- The configs, the analytic counts, ``batch_dims``, the parameter trees
  (leaves, shapes, dtypes, init scales), the specs and the synthetic
  pipeline (tokens bit-equal to the reference's; frames and patches to its
  draw at the port's stable key, the same in every process).
- Serving against ``jit_prefill_step`` on Auto ``(8, 1)`` meshes in every
  mode, and phi-3-vision on ``(2, 4)`` with sequence parallelism; then
  prefill-then-decode against the reference's prefill step and its decode
  steps driven by hand from the prefill's cache, padded as
  ``transformer.decode_cache`` pads it (the reference's ``greedy_generate``
  decodes the prompt with no patches and runs the encdec against zero
  cross K/V, so it is no oracle here).
- 2 training steps in every mode (phi-3-vision on ``(8, 1)`` and ``(2,
  4)``, whisper on ``(8, 1)``), and with ``grad_accum=2``, against
  ``jit_train_step`` in the same mode where the reference runs it (xla,
  and phi-3-vision's mcast on ``(8, 1)``), else its xla step: the
  reference's mcast train steps of the encdec take 16 to 54 s each to
  compile. Every batch is made here and handed to both.

The mesh references run in one subprocess with 8 fake CPU devices
(``run_reference``), started first; the port's runs go on beside it.
Tolerances: the pieces 1e-5 (``_posenc`` bitwise); prefill logits and
caches 1e-5; decode logits 1e-5 and the same tokens; training loss 1e-6
and grad_norm 1e-5, relative, parameters 1e-5. The port's prefill logits
and caches and its first-step losses are bitwise equal across its modes.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MeshConfig as RefMeshConfig
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import arch_names as ref_arch_names
from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticPipeline as RefPipeline
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro.models import transformer as ref_transformer
from repro.models.model_builder import batch_dims as ref_batch_dims
from repro.models.model_builder import count_params_analytic as ref_count
from repro.sharding import specs as ref_specs
from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, arch_names, get_model_config, reduced, replace)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import batch_dims, count_params_analytic, encdec, make_dummy_batch
from repro_torch.models import transformer
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding import specs
from repro_torch.sharding.fsdp import at_use
from test_torch_support import (REPO, SRC, flatten, one_torch_thread,  # noqa: F401
                                run_reference, serve_run)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("phi-3-vision-4.2b", "whisper-base")
NEW_ARCHS = ARCHS + ("moonshot-v1-16b-a3b",)
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
MESHES = {"8x1": (8, 1), "2x4": (2, 4)}
B, S_TOK, S_ENC, NEW = 8, 16, 20, 6     # serving: batch, prompt tokens, frames, new tokens
N_PATCHES = 8                            # the reduced vlm's (``reduced``)
# the decode cache: the prefill's stream and the new tokens; 32 splits over
# tp = 4 (phi-3-vision's flash-decoding on (2, 4))
CACHE_LEN = {"phi-3-vision-4.2b": N_PATCHES + S_TOK + NEW + 2, "whisper-base": S_TOK + NEW}
SERVE = {f"{a}/8x1": (a, "8x1", MODES) for a in ARCHS}
SERVE["phi-3-vision-4.2b/2x4"] = ("phi-3-vision-4.2b", "2x4", ["xla", "mcast"])
SHAPE = ShapeConfig("t", "train", 32, 16)     # 32 positions: 8 patches + 24 tokens
STEPS = 2
# training cases: name -> (arch, mesh, mode, grad_accum)
TRAIN = {f"{a}/{m}/{mode}": (a, m, mode, 1) for a, m in
         (("phi-3-vision-4.2b", "8x1"), ("phi-3-vision-4.2b", "2x4"), ("whisper-base", "8x1"))
         for mode in MODES}
TRAIN.update({f"{a}/8x1/mcast/accum2": (a, "8x1", "mcast", 2) for a in ARCHS})
# the reference's training runs, by the same names
REF_TRAIN = {name: TRAIN[name] for name in TRAIN if TRAIN[name][2] == "xla"}
REF_TRAIN["phi-3-vision-4.2b/8x1/mcast"] = TRAIN["phi-3-vision-4.2b/8x1/mcast"]
REF_TRAIN.update({f"{a}/8x1/xla/accum2": (a, "8x1", "xla", 2) for a in ARCHS})
# the leaves that are zeros at init, drawn here so that the (1 + w) of
# rms_norm is exercised
_VECTORS = ("ln1", "ln2", "ln_x", "enc_ln", "final_ln")


def cfg_of(arch: str):
    return reduced(get_model_config(arch))


def ref_cfg_of(arch: str):
    return ref_reduced(ref_model_config(arch))


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


def prompt_of(arch: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A serving batch: the tokens, and the patches or frames beside them."""
    cfg = cfg_of(arch)
    rng = np.random.default_rng(seed + len(arch))
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_TOK)).astype(np.int32)}
    if cfg.family == "vlm":
        shp = (B, N_PATCHES, cfg.vision.patch_dim)
        out["patches"] = (rng.standard_normal(shp) * 0.02).astype(np.float32)
    else:
        out["frames"] = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _stream(arch: str) -> int:
    return S_TOK + (N_PATCHES if arch == "phi-3-vision-4.2b" else 0)


def _mesh(name: str) -> StackedMesh:
    d, m = MESHES[name]
    return StackedMesh(data=d, model=m)


def _layer(tree: dict, i: int = 0):
    """Layer i of a stacked numpy tree: (jax tree, port tree with one rank)."""
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i] for k, v in node.items()}
    layer = take(tree)
    port = jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a))[None], layer)
    return jax.tree.map(jnp.asarray, layer), port


def _one_rank(tree: dict):
    return (jax.tree.map(jnp.asarray, tree),
            bridge.to_torch(tree, None, MeshConfig(), dtype=torch.float32, device="cpu"))


# ----------------------------------------------------------- the pieces


def test_patch_stream_matches_jax():
    """``patch_proj`` over the patches, joined ahead of the token
    embeddings: the reference's stream (``transformer.py:262``), 1e-5."""
    arch = "phi-3-vision-4.2b"
    cfg, rc = cfg_of(arch), ref_cfg_of(arch)
    jp, pp = _one_rank(tree_of(cfg, 1))
    batch = prompt_of(arch)
    x = ref_transformer.embed_tokens(jp, rc, jnp.asarray(batch["tokens"]))
    proj = jnp.einsum("bpe,ed->bpd", jnp.asarray(batch["patches"]), jp["patch_proj"])
    want = np.asarray(jnp.concatenate([proj, x], axis=1))
    tb = _torch(batch)
    got = transformer.embed_patches(pp, cfg, tb, tb["tokens"][None])
    assert got.shape == (1, B, N_PATCHES + S_TOK, cfg.d_model)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)


def test_posenc_matches_jax_and_is_made_once():
    """The sinusoidal positions bitwise (the reference's numpy table), the
    table made once a length and device."""
    x = np.random.default_rng(2).standard_normal((3, 21, 64)).astype(np.float32)
    want = np.asarray(ref_encdec._posenc(jnp.asarray(x)))
    encdec.position_table.cache_clear()
    for _ in range(2):
        got = encdec._posenc(torch.from_numpy(x)[None])
        np.testing.assert_array_equal(got[0].numpy(), want)
    assert encdec.position_table.cache_info().misses == 1
    np.testing.assert_array_equal(encdec.sinusoidal_positions(21, 64),
                                  np.asarray(jnp.asarray(
                                      ref_encdec.layers.sinusoidal_positions(21, 64))))


def test_encode_matches_jax():
    """The encoder over 20 frames (non-causal attention, gelu MLP, enc_ln)
    at q and kv blocks of 8, so several blocks run: 1e-5."""
    cfg = replace(cfg_of("whisper-base"), attn_q_block=8, attn_kv_block=8)
    rc = dataclasses.replace(ref_cfg_of("whisper-base"), attn_q_block=8, attn_kv_block=8)
    jp, pp = _one_rank(tree_of(cfg, 2))
    frames = prompt_of("whisper-base")["frames"]
    want = np.asarray(ref_encdec.encode(jp, rc, jnp.asarray(frames)))
    got = encdec.encode(pp, cfg, torch.from_numpy(frames)[None])
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)


def test_dec_block_matches_jax():
    """One decoder block: causal self-attention, ``ln_x`` and cross-attention
    over 20 encoder states, the gelu MLP; the block's output and its k, v,
    xk, xv: 1e-5."""
    cfg, rc = cfg_of("whisper-base"), ref_cfg_of("whisper-base")
    jp, pp = _layer(tree_of(cfg, 3)["dec_blocks"], 1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S_ENC, cfg.d_model)).astype(np.float32)
    want, wkv = ref_encdec._dec_block(jp, jnp.asarray(x), rc, jnp.asarray(enc), want_kv=True)
    got, gkv = encdec._dec_block(pp, torch.from_numpy(x)[None], cfg, torch.from_numpy(enc)[None],
                                 want_kv=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for g, w in zip(gkv, wkv):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_encdec_decode_step_matches_jax():
    """Two decode steps from a random cache (self K/V of 12 positions, cross
    K/V of 20), rows at different positions: the logits 1e-5, the written
    rows, and the cross K/V left as they were."""
    cfg, rc = cfg_of("whisper-base"), ref_cfg_of("whisper-base")
    jp, pp = _one_rank(tree_of(cfg, 5))
    rng = np.random.default_rng(6)
    b, kv, hd, layers_ = 3, cfg.num_kv_heads, cfg.head_dim, cfg.encdec.dec_layers
    cache = {n: rng.standard_normal((layers_, b, kv, s, hd)).astype(np.float32)
             for n, s in (("k", 12), ("v", 12), ("xk", S_ENC), ("xv", S_ENC))}
    jc = {n: jnp.asarray(c) for n, c in cache.items()}
    pc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    pos = np.array([4, 7, 9], np.int32)
    tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    for step in range(2):
        want, jc = ref_encdec.encdec_decode_step(jp, rc, jc, jnp.asarray(tok), jnp.asarray(pos))
        got, pc = encdec.encdec_decode_step(pp, cfg, pc, torch.from_numpy(tok).long(),
                                            torch.from_numpy(pos).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        for n in ("k", "v"):
            np.testing.assert_allclose(pc[n].numpy(), np.asarray(jc[n]), atol=1e-5, rtol=0)
        for n in ("xk", "xv"):
            np.testing.assert_array_equal(pc[n].numpy(), cache[n])
        tok, pos = np.asarray(jnp.argmax(want, -1)).astype(np.int32), pos + 1


# --------------------------------------- configs, counts, trees, specs, data


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_counts_and_dims_equal_reference(arch):
    """The config and its reduced form are the reference's; the analytic
    count (with ``active_only`` too) and ``batch_dims`` of every shape kind
    equal the reference's, at full size and reduced."""
    full, ref_full = get_model_config(arch), ref_model_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.n_params() == {"phi-3-vision-4.2b": 3_824_025_600,
                               "whisper-base": 97_149_952,
                               "moonshot-v1-16b-a3b": 28_888_268_800}[arch]
    for cfg, rc in ((full, ref_full), (cfg_of(arch), ref_cfg_of(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rc)
        for active in (False, True):
            assert count_params_analytic(cfg, active_only=active) == ref_count(
                rc, active_only=active)
        for kind, seq in (("train", 2048), ("prefill", 1536), ("decode", 4096)):
            got = batch_dims(cfg, ShapeConfig("s", kind, seq, 4))
            want = ref_batch_dims(rc, RefShapeConfig("s", kind, seq, 4))
            assert got == want, (kind, got, want)


def test_registry_holds_every_reference_arch():
    """Every ``--arch`` of the reference, and every family among them."""
    from repro_torch.models.model_builder import FAMILIES
    assert set(arch_names()) == set(ref_arch_names())
    assert len(arch_names()) == 10
    assert set(FAMILIES) == {get_model_config(a).family for a in arch_names()}
    assert len(FAMILIES) == 6


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_trees_equal_reference(arch):
    """The parameter tree has the reference's leaves, shapes and dtypes
    (``init_params`` in bf16) and its init scales: each drawn leaf's
    standard deviation within 20 % of the reference's own draw, the
    reference's zero leaves zero. The reduced tree's weights, less the norm
    scales, are the analytic count."""
    cfg, rc = cfg_of(arch), ref_cfg_of(arch)
    rc16 = dataclasses.replace(rc, param_dtype="bfloat16")
    want = flatten(jax.eval_shape(ref_build_model(rc16).init_params, jax.random.PRNGKey(0)))
    port = flatten(bridge.to_torch(bridge.random_params(cfg, 0), None, MeshConfig(),
                                   dtype=torch.bfloat16, device="cpu"))
    assert sorted(port) == sorted(want)
    for key, leaf in port.items():
        assert tuple(leaf.local.shape[1:]) == want[key].shape, key
        assert str(leaf.local.dtype).split(".")[-1] == str(want[key].dtype), key
    drawn = flatten(jax.tree.map(np.asarray, ref_build_model(rc).init_params(
        jax.random.PRNGKey(1))))
    ours = flatten(bridge.random_params(cfg, 1))
    for key, a in ours.items():
        w = drawn[key]
        if not w.any():
            assert not a.any(), key
        else:
            assert a.std() == pytest.approx(float(w.std()), rel=0.2), key
    norms = sum(a.size for k, a in ours.items() if k.split("/")[-1] in _VECTORS)
    assert sum(a.size for a in ours.values()) - norms == count_params_analytic(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_device_params_layout_matches_to_torch(arch):
    """``device_params`` gives the leaves, specs, shapes and dtypes of
    ``to_torch(random_params(...))`` on (8, 1), in the init scales
    (``patch_proj`` replicated; the norm scales, ``ln_x`` and ``enc_ln``
    included, zero and f32)."""
    cfg = cfg_of(arch)
    mesh = StackedMesh(data=8, model=1)
    want = flatten(bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                                   dtype=torch.bfloat16, device="cpu"))
    got = flatten(bridge.device_params(cfg, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16,
                                       device="cpu"))
    assert got.keys() == want.keys()
    table = flatten(bridge._param_table(cfg))
    for key, leaf in got.items():
        w = want[key]
        assert (leaf.spec, leaf.local.shape, leaf.local.dtype) == \
            (w.spec, w.local.shape, w.local.dtype), key
        g = leaf.local.float()
        if not table[key].scale:
            assert leaf.local.dtype == torch.float32 and torch.all(g == 0), key
        else:
            assert g.std().item() == pytest.approx(table[key].scale, rel=0.15), key


def test_specs_match_reference():
    """Every leaf's spec is the reference's ``param_pspecs``: the reduced
    phi-3-vision and whisper at ``(8, 1)``, phi-3-vision at ``(2, 4)``
    (``patch_proj`` replicated; the gelu MLP's ``w_out`` as ``wo``); the
    encdec cache's ``cache_pspecs`` (``xk``/``xv`` as ``k``/``v``) at
    both meshes."""
    norm = lambda s: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)
    for arch, meshes in (("phi-3-vision-4.2b", MESHES), ("whisper-base", {"8x1": (8, 1)})):
        tree = bridge.random_params(cfg_of(arch), 0)
        for d, m in meshes.values():
            axes = {"data": d, "model": m}
            got = flatten(specs.param_pspecs(tree, StackedMesh(**axes), MeshConfig()))
            want = flatten(ref_specs.param_pspecs(tree, SimpleNamespace(shape=axes),
                                                  RefMeshConfig()))
            assert sorted(got) == sorted(want)
            for key, spec in got.items():
                assert norm(spec) == norm(tuple(want[key])), (arch, axes, key)
    got = flatten(specs.param_pspecs(bridge.random_params(cfg_of("whisper-base"), 0),
                                     StackedMesh(data=8, model=1), MeshConfig()))
    assert got["dec_blocks/mlp/w_out"] == (None, "model", ("data",))
    assert got["enc_blocks/mlp/w_in"] == (None, ("data",), "model")
    cfg = cfg_of("whisper-base")
    cache = encdec.encdec_init_cache(cfg, B, 24, torch.float32, "cpu")
    ref_cache = ref_build_model(ref_cfg_of("whisper-base")).init_cache(B, 24)
    for axes in ({"data": 8, "model": 1}, {"data": 2, "model": 4}):
        got = flatten(specs.cache_pspecs(cfg, cache, StackedMesh(**axes), MeshConfig()))
        want = flatten(ref_specs.cache_pspecs(ref_cfg_of("whisper-base"), ref_cache,
                                              SimpleNamespace(shape=axes), RefMeshConfig(), 24))
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert norm(got[key]) == norm(tuple(spec)), (axes, key)
            assert tuple(cache[key].shape) == ref_cache[key].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_bit_equal_to_reference(arch):
    """``SyntheticPipeline``: the tokens and targets of the train and prefill
    batches bitwise the reference's (the vlm targets -1 over the patches);
    the frames and patches (f32) bitwise the reference's draw formula
    (``repro.data.pipeline._full``) at the port's stable key,
    ``zlib.crc32(name) & 0xFFFF``, where the reference keys on the salted
    ``hash(name)``."""
    cfg, rc = cfg_of(arch), ref_cfg_of(arch)
    for kind in ("train", "prefill"):
        shape = ShapeConfig("t", kind, 32, 4)
        got = SyntheticPipeline(cfg, shape, device="cpu")
        want = RefPipeline(rc, RefShapeConfig("t", kind, 32, 4))
        for step in (0, 3):
            g, w = got.next_batch(step), want.next_batch(step)
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == (torch.float32 if k in ("frames", "patches")
                                      else torch.long), k
                if k in ("frames", "patches"):
                    key = zlib.crc32(k.encode()) & 0xFFFF
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [want.data.seed, step, key]))
                    ref = (rng.standard_normal(want.dims[k]) * 0.02).astype(np.float32)
                    np.testing.assert_array_equal(g[k].numpy(), ref, err_msg=k)
                    continue
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
            if cfg.family == "vlm" and kind == "train":
                assert (g["targets"][:, :N_PATCHES] == -1).all()
                assert (g["targets"][:, N_PATCHES:] >= 0).all()


_PIPELINE_DRAW = """
import hashlib, sys
import torch
from repro_torch.configs import get_model_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
for arch in ("whisper-base", "phi-3-vision-4.2b"):
    cfg = reduced(get_model_config(arch))
    b = SyntheticPipeline(cfg, ShapeConfig("t", "train", 32, 4), device="cpu").next_batch(2)
    for k in sorted(b):
        print(arch, k, hashlib.sha256(b[k].float().numpy().tobytes()).hexdigest())
"""


def test_pipeline_frames_stable_across_processes():
    """Two processes with different ``PYTHONHASHSEED`` draw the same frames
    and patches bitwise (and the same tokens and targets)."""
    outs = []
    for seed in ("1", "977"):
        env = dict(os.environ, PYTHONHASHSEED=seed,
                   PYTHONPATH=os.pathsep.join([SRC, os.environ.get("PYTHONPATH", "")]))
        run = subprocess.run([sys.executable, "-c", _PIPELINE_DRAW], env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        outs.append(run.stdout)
    assert "frames" in outs[0] and "patches" in outs[0]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_make_dummy_batch(arch):
    cfg = cfg_of(arch)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", kind, 32, 4)
        a = make_dummy_batch(cfg, shape, torch.Generator().manual_seed(1), device="cpu")
        assert {k: tuple(v.shape) for k, v in a.items()} == batch_dims(cfg, shape)
        for k, v in a.items():
            assert v.dtype == (torch.float32 if k in ("frames", "patches") else torch.long)
        if kind == "train" and cfg.family == "vlm":
            assert (a["targets"][:, :N_PATCHES] == -1).all()


# -------------------------------------------------- the reference's runs

_BODY = f'''
import jax.numpy as jnp
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced)
from repro.optim import adamw
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
from repro.runtime.train_loop import TrainState, jit_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        OUT[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

def mesh_cfg(shape):
    class Cfg(MeshConfig):
        @property
        def shape(self): return shape
        @property
        def axes(self): return ("data", "model")
    return Cfg()

meshes = {{name: ref_mesh(shape, ("data", "model")) for name, shape in {MESHES}.items()}}
for name, (arch, mesh_name, modes) in {SERVE}.items():
    cfg = reduced(get_model_config(arch))
    mesh, mcfg = meshes[mesh_name], mesh_cfg({MESHES}[mesh_name])
    params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/serve/"))
    batch = {{k[len(arch) + 8:]: v for k, v in IN.items() if k.startswith(arch + "/prompt/")}}
    s0 = {S_TOK} + (batch["patches"].shape[1] if "patches" in batch else 0)
    for mode in modes:
        run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", s0, {B}), mesh=mcfg,
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, step = jit_prefill_step(run, mesh)
        logits, cache = step(params, batch)
        OUT[f"{{name}}/{{mode}}/logits"] = np.asarray(logits)
        put(f"{{name}}/{{mode}}/cache/", cache)
    # decode from the prefill's cache: k and v padded to the cache length,
    # the cross K/V as they are
    cache_len = {CACHE_LEN}[arch]
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", cache_len, {B}), mesh=mcfg,
                    collective=CollectiveConfig(fsdp_mode="xla"))
    _, dec = jit_decode_step(run, mesh)
    pre = unflatten(OUT, f"{{name}}/xla/cache/")
    cache = {{n: np.pad(c, [(0, 0)] * 3 + [(0, cache_len - s0), (0, 0)]) if n in ("k", "v")
             else c for n, c in pre.items()}}
    state = ServeState(cache, np.full(({B},), s0, np.int32))
    tok = np.argmax(OUT[f"{{name}}/xla/logits"], -1).astype(np.int32)
    toks, lgs = [tok], []
    for _ in range({NEW - 1}):
        lg, state = dec(params, state, tok)
        tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
        lgs.append(np.asarray(lg))
        toks.append(tok)
    OUT[name + "/decode/logits"], OUT[name + "/decode/tokens"] = np.stack(lgs), np.stack(toks, 1)

for name, (arch, mesh_name, mode, accum) in {REF_TRAIN}.items():
    cfg = reduced(get_model_config(arch))
    shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
    run = RunConfig(model=cfg, shape=shape, mesh=mesh_cfg({MESHES}[mesh_name]),
                    train=TrainConfig(steps=5, grad_accum=accum),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    try:
        _, jstep = jit_train_step(run, meshes[mesh_name])
        params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/train/"))
        state = TrainState(params, adamw.init(params))
        for i in range({STEPS}):
            batch = unflatten(IN, f"{{arch}}/batch{{i}}/")
            state, m = jstep(state, batch)
            for key in ("loss", "grad_norm"):
                OUT[f"{{name}}/{{key}}{{i}}"] = np.asarray(m[key])
        put(name + "/params/", state.params)
    except Exception as e:
        print(name, "failed:", repr(e)[:300], file=sys.stderr)
'''


def _serve(name: str, tree) -> dict:
    arch, mesh_name, modes = SERVE[name]
    cfg, mesh = cfg_of(arch), _mesh(mesh_name)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    batch = _torch(prompt_of(arch))
    s0, cache_len = _stream(arch), CACHE_LEN[arch]
    out = {}
    for mode in MODES:
        _, _, prefill = make_prefill_step(serve_run(cfg, mode, B, s0), mesh, device="cpu")
        out[mode] = prefill(params, batch)
    logits, pre = out["xla"]
    _, _, decode = make_decode_step(serve_run(cfg, "xla", B, cache_len, "decode"), mesh,
                                    device="cpu")
    state = ServeState(transformer.decode_cache(cfg, pre, s0, cache_len),
                       torch.full((B,), s0, dtype=torch.long))
    tok = logits.argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    out["decode"] = (torch.stack(lgs), torch.stack(toks, 1))
    inputs = {k: v for k, v in batch.items() if k != "tokens"}
    for mode in modes:
        _, _, prefill = make_prefill_step(serve_run(cfg, mode, B, s0), mesh, device="cpu")
        out[f"greedy/{mode}"] = greedy_generate(prefill, decode, params, batch["tokens"], NEW,
                                                cache_len, inputs)
    return out


def _batches(arch: str) -> list[dict]:
    pipe = SyntheticPipeline(cfg_of(arch), SHAPE, device="cpu")
    return [pipe.next_batch(i) for i in range(STEPS)]


def _train(name: str, tree, batches, *, remat: str = "full", prefetch: bool = False):
    arch, mesh_name, mode, accum = TRAIN[name]
    cfg, mesh = cfg_of(arch), _mesh(mesh_name)
    run = RunConfig(model=cfg, shape=SHAPE, train=TrainConfig(steps=5, remat=remat,
                                                              grad_accum=accum),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2, prefetch=prefetch))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                     MeshConfig()))
    return metrics, params


@pytest.fixture(scope="module")
def case():
    """The reference's serving and training in one subprocess, started
    first; the port's beside it."""
    serve_trees = {a: tree_of(cfg_of(a), 10 + i) for i, a in enumerate(ARCHS)}
    train_trees = {a: tree_of(cfg_of(a), 20 + i) for i, a in enumerate(ARCHS)}
    batches = {a: _batches(a) for a in ARCHS}
    inputs = {}
    for a in ARCHS:
        inputs.update({f"{a}/serve/{k}": v for k, v in flatten(serve_trees[a]).items()})
        inputs.update({f"{a}/train/{k}": v for k, v in flatten(train_trees[a]).items()})
        inputs.update({f"{a}/prompt/{k}": v for k, v in prompt_of(a).items()})
        for i, batch in enumerate(batches[a]):
            inputs.update({f"{a}/batch{i}/{k}": v.numpy().astype(
                np.int32 if v.dtype == torch.long else np.float32) for k, v in batch.items()})
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, _BODY, inputs)
        port = {name: _serve(name, serve_trees[SERVE[name][0]]) for name in SERVE}
        port.update({name: _train(name, train_trees[TRAIN[name][0]],
                                  batches[TRAIN[name][0]]) for name in TRAIN})
        return dict(ref=ref.result(), port=port, trees=train_trees, batches=batches)


# --------------------------------------------------------------- serving


def _prefill_cases():
    return [(name, mode) for name, (_, _, modes) in SERVE.items() for mode in modes]


@pytest.mark.parametrize("name,mode", _prefill_cases())
def test_prefill_matches_jax(case, name, mode):
    """Last-position logits and every cache leaf (the vlm's k and v over
    the patches and the tokens; the encdec's k, v and its cross K/V over
    the frames) against the reference's prefill in the same mode, 1e-5."""
    arch = SERVE[name][0]
    cfg, ref = cfg_of(arch), case["ref"]
    logits, cache = case["port"][name][mode]
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref[f"{name}/{mode}/logits"], atol=1e-5, rtol=0)
    got = flatten(cache)
    want = {k[len(f"{name}/{mode}/cache/"):]: v for k, v in ref.items()
            if k.startswith(f"{name}/{mode}/cache/")}
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        assert a.shape == want[key].shape, key
        np.testing.assert_allclose(a.numpy(), want[key], atol=1e-5, rtol=0, err_msg=key)
    if arch == "whisper-base":
        assert got["xk"].shape[3] == S_ENC and got["k"].shape[3] == S_TOK


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_modes_agree_bitwise(case, name):
    base_logits, base_cache = case["port"][name]["xla"]
    for mode in MODES:
        logits, cache = case["port"][name][mode]
        assert torch.equal(logits, base_logits), mode
        assert all(torch.equal(cache[n], base_cache[n]) for n in cache), mode


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_then_decode_matches_jax(case, name):
    """5 decode steps from the prefill's cache (the vlm's at position
    n_patches + S, the encdec's cross K/V frozen at 20 frames) against the
    reference's decode steps from its padded prefill cache: the same tokens,
    logits within 1e-5; ``greedy_generate`` gives those tokens in every
    mode."""
    ref, port = case["ref"], case["port"][name]
    lgs, toks = port["decode"]
    np.testing.assert_array_equal(toks.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(lgs.numpy(), ref[name + "/decode/logits"], atol=1e-5, rtol=0)
    for mode in SERVE[name][2]:
        out = port[f"greedy/{mode}"]
        assert out.shape == (B, S_TOK + NEW)
        np.testing.assert_array_equal(out[:, S_TOK:].numpy(), ref[name + "/decode/tokens"],
                                      err_msg=mode)


# --------------------------------------------------------------- training


def _ref_train(name: str) -> str:
    """The reference's run a port case is held against: the same mesh,
    mode and ``grad_accum``, or its xla step."""
    arch, mesh_name, mode, accum = TRAIN[name]
    for m in (mode, "xla"):
        key = f"{arch}/{mesh_name}/{m}" + ("/accum2" if accum == 2 else "")
        if key in REF_TRAIN:
            return key
    raise KeyError(name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_jax(case, name):
    """2 steps against ``jit_train_step`` on the same mesh and ``grad_accum``
    from the same batches: loss within 1e-6 and grad_norm within 1e-5,
    relative; every parameter within 1e-5."""
    ref = case["ref"]
    metrics, params = case["port"][name]
    name = _ref_train(name)
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{name}/loss{i}"]), rel=1e-6), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{name}/grad_norm{i}"]), rel=1e-5), i
    for key, a in params.items():
        np.testing.assert_allclose(a, ref[f"{name}/params/{key}"], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("mesh_arch", ["phi-3-vision-4.2b/8x1", "phi-3-vision-4.2b/2x4",
                                       "whisper-base/8x1"])
def test_train_modes_agree_bitwise_on_the_first_loss(case, mesh_arch):
    first = {mode: case["port"][f"{mesh_arch}/{mode}"][0][0]["loss"] for mode in MODES}
    assert len(set(first.values())) == 1, first


def test_encdec_remat_and_prefetch_leave_the_step_bitwise(case):
    """The reference checkpoints an encdec layer only for remat="full" and
    prefetches nothing there: "none", "dots" and prefetch give the losses,
    grad norms and parameters of the "full" step bitwise."""
    name = "whisper-base/8x1/mcast"
    base = case["port"][name]
    for remat, prefetch in (("none", False), ("dots", False), ("full", True)):
        metrics, params = _train(name, case["trees"]["whisper-base"],
                                 case["batches"]["whisper-base"], remat=remat,
                                 prefetch=prefetch)
        assert [(m["loss"], m["grad_norm"]) for m in metrics] == \
            [(m["loss"], m["grad_norm"]) for m in base[0]], (remat, prefetch)
        for key, a in params.items():
            assert np.array_equal(a, base[1][key]), (remat, prefetch, key)


# --------------------------------------------------------- launchers, counts


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launchers_take_the_new_archs(arch, tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--fsdp-mode", "mcast"])
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
                "--seq", "32", "--fsdp-mode", "mcast_bcast", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu" in out and "8 prompt + 3 new tokens" in out
    assert ("8 patches + " in out) == (arch == "phi-3-vision-4.2b")
    assert "step     1 loss" in out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_sim_profiles_match_reference(arch):
    """``core/train_sim``'s layer profiles, which take the analytic count,
    equal the reference's for the three configs."""
    from repro.core import train_sim as ref_ts
    from repro_torch.core import train_sim as ts
    for kw in (dict(dp=16), dict(dp=8, tp=2, grad_accum=4, remat="none")):
        got = ts.derive_layer_profiles(arch, **kw)
        want = ref_ts.derive_layer_profiles(arch, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert dataclasses.astuple(g) == dataclasses.astuple(w), (arch, kw)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launches_match_chip_smoke(monkeypatch, arch):
    """``chip_smoke.fam_launches`` (the counts phases 3h and 4h assert on the
    card) is what the code launches, and ``fam_matmul_cases`` the shapes of
    its products: a prefill, a decode step and a train step (remat="full",
    3 cross-entropy chunks for phi-3-vision as in 4h) of the reduced config
    in bf16 on (8, 1), whisper's at an odd vocab (259) as its 51,865 (the
    head on the wmma kernel, ``collective_matmul.path``); phi-3-vision's
    prefill on (2, 4) against ``fam_tp_launches``. On the card each gather,
    transpose and product is one launch (a schedule of at most 128
    entries)."""
    from collections import Counter

    from repro_torch.core import collectives as C
    from repro_torch.kernels import collective_matmul as M
    cs = _chip_smoke()
    keys = ("ring_allgather", "ring_allgather_transpose", "matmul", "matmul_wmma", "matmul_f32")
    counts, shapes = dict.fromkeys(keys, 0), Counter()

    def spy(name, fn):
        def wrapped(*args, **kw):
            key = name
            if name == "matmul":
                x, w = args[:2]
                key = {"wgmma": "matmul", "wmma": "matmul_wmma", "f32": "matmul_f32"}[
                    M.path(x, w)]
                shapes[(x.shape[0], x.shape[1], x.shape[2], w.shape[2], x.dtype)] += 1
            counts[key] += 1
            return fn(*args, **kw)
        return wrapped

    for module, name in ((C, "ring_allgather"), (C, "ring_allgather_transpose"), (M, "matmul")):
        monkeypatch.setattr(module, name, spy(name, getattr(module, name)))

    def take():
        out, got = dict(counts), Counter(shapes)
        counts.update(dict.fromkeys(counts, 0))
        shapes.clear()
        return out, got

    def want_shapes(cases):
        out = Counter()
        for (r, m, k, n, *_, dt), c in cases.items():
            out[(r, m, k, n, dt)] += c
        return out

    full = get_model_config(arch)
    cfg = replace(reduced(full), param_dtype="bfloat16", compute_dtype="bfloat16",
                  attn_q_block=512, attn_kv_block=1024)
    if arch == "whisper-base":
        cfg = replace(cfg, vocab_size=259)
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                             dtype=torch.bfloat16, device="cpu")
    batch = cs._fam_batch(cfg, 16, 16, torch.Generator().manual_seed(0), "cpu")
    s0 = transformer.stream_len(cfg, batch)
    np_ = s0 - 16
    run = serve_run(cfg, "mcast", B, s0)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    take()
    logits, pre = prefill(params, batch)
    got, got_shapes = take()
    assert got == cs.fam_launches(cfg, "prefill")
    assert got_shapes == want_shapes(cs.fam_matmul_cases(cfg, 8, s0, "prefill", head_m=1,
                                                         patch_m=np_))
    state = ServeState(transformer.decode_cache(cfg, pre, s0, s0 + 1), torch.full((B,), s0))
    decode(params, state, logits.argmax(-1))
    got, got_shapes = take()
    assert got == cs.fam_launches(cfg, "decode")
    assert got_shapes == want_shapes(cs.fam_matmul_cases(cfg, 8, 1, "decode", head_m=1))
    seq, tb = (1536, 8) if cfg.family == "vlm" else (32, 16)
    shape = ShapeConfig("t", "train", seq, tb)
    trun = RunConfig(model=cfg, shape=shape, collective=CollectiveConfig(fsdp_mode="mcast"))
    _, _, step = make_train_step(trun, mesh, device="cpu")
    tstate = init_state(trun, mesh, bridge.random_params(cfg, 0), device="cpu")
    take()
    step(tstate, SyntheticPipeline(cfg, shape, device="cpu").next_batch(0))
    got, got_shapes = take()
    assert got == cs.fam_launches(cfg, "train", seq)
    m = tb // 8 * seq
    assert got_shapes == want_shapes(cs.fam_matmul_cases(
        cfg, 8, m, "train", head_m=tb // 8 * min(seq, 512), chunks=-(-seq // 512),
        patch_m=tb // 8 * np_))
    if cfg.family == "vlm":
        tp = cs.FAM_TP_MESH
        tparams = bridge.to_torch(bridge.random_params(cfg, 0), tp, MeshConfig(),
                                  dtype=torch.bfloat16, device="cpu")
        _, _, tprefill = make_prefill_step(run, tp, device="cpu")
        tprefill(tparams, batch)
        got, _ = take()
        want = cs.fam_tp_launches(cfg, "mcast")
        assert {k: got[k] for k in want} == want

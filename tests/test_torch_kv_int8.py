"""The port's int8 KV cache against the JAX package's (``kv_cache_dtype =
"int8"``: symmetric per-vector int8 with an f32 scale a position, reference
``attention.py:337``, ``transformer.py:100-112, 277-281, 318-323``).

- ``quantize_kv`` / ``dequantize_kv`` in-process on the same numpy inputs:
  the int8 values and the scales equal the reference's, bitwise.
- Reduced smollm-135m, granite-34b and yi-9b served with the int8 cache on
  ``StackedMesh(data=2, model=4)`` and ``(data=4, model=2)`` (flash-decoding
  over the sequence shards) and smollm-135m on ``(data=8, model=1)``,
  against ``jit_prefill_step`` / ``jit_decode_step`` on the same Auto mesh
  (one subprocess with 8 fake CPU devices): prefill logits
  1e-5; the cache's scales 1e-5 (relative) and its int8 values equal but
  where the reference's unquantised value lies within 1e-3 of a rounding
  tie (there the f32 sums in another order may round to the neighbour);
  decode from the reference's prefill cache: logits 1e-4, the same tokens,
  the new positions' scales 1e-5 and int8 rows at most one apart.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import dequantize_kv as ref_dequantize
from repro.models.attention import quantize_kv as ref_quantize
from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 get_model_config, reduced)
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import attention as attn
from repro_torch.runtime.serve_loop import ServeState, make_decode_step, make_prefill_step
from test_torch_support import flatten, one_torch_thread, random_tree, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("smollm-135m", "granite-34b", "yi-9b")
MESHES = {"2x4": (2, 4), "4x2": (4, 2), "8x1": (8, 1)}
CASES = {f"{a}/{m}": (a, m) for a in ARCHS for m in ("2x4", "4x2")}
CASES["smollm-135m/8x1"] = ("smollm-135m", "8x1")
B, S, NEW = 8, 16, 8
TIE = 1e-3


def _cfg(arch: str, kv: str = "int8"):
    return dataclasses.replace(reduced(get_model_config(arch)), kv_cache_dtype=kv)


def _tokens(name: str) -> np.ndarray:
    return np.random.default_rng(50 + list(CASES).index(name)).integers(
        0, _cfg(CASES[name][0]).vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------------------- quantisation


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 2, 16, 32)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                      # an all-zero vector: the 1e-8 floor
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xr = jnp.asarray(x).astype(getattr(jnp, dtype))
    q, s = attn.quantize_kv(xt)
    rq, rs = ref_quantize(xr)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    y = attn.dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref_dequantize(rq, rs, jnp.float32)))


def test_init_cache_is_int8_with_scales():
    from repro_torch.models import build_model
    cfg = _cfg("yi-9b")
    cache = build_model(cfg, device="cpu").init_cache(2, 8)
    shp = (cfg.num_layers, 2, cfg.num_kv_heads, 8, cfg.head_dim)
    assert cache["k"].dtype == torch.int8 and cache["k"].shape == shp
    assert cache["ks"].dtype == torch.float32 and cache["ks"].shape == shp[:-1] + (1,)


# ------------------------------------------------------------------ serving


_BODY = f'''
import dataclasses
import jax.numpy as jnp
from repro.configs import CollectiveConfig, RunConfig, ShapeConfig, get_model_config, reduced
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step

for name, (arch, mesh_name) in {CASES}.items():
    mesh = ref_mesh({MESHES}[mesh_name], ("data", "model"))
    params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/"))
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(reduced(get_model_config(arch)), kv_cache_dtype=kv)
        run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                        collective=CollectiveConfig(fsdp_mode="xla"))
        _, step = jit_prefill_step(run, mesh)
        logits, cache = step(params, {{"tokens": IN["tokens/" + name]}})
        for n, c in cache.items():
            OUT[f"{{name}}/{{kv}}/{{n}}"] = np.asarray(c)
    OUT[name + "/logits"] = np.asarray(logits)
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + NEW}, {B}))
    _, dec = jit_decode_step(run, mesh)
    cache = {{n: np.pad(OUT[f"{{name}}/int8/{{n}}"], [(0, 0)] * 3 + [(0, {NEW}), (0, 0)])
             for n in ("k", "v", "ks", "vs")}}
    state = ServeState(cache, np.full(({B},), {S}, np.int32))
    tok = np.argmax(OUT[name + "/logits"], -1).astype(np.int32)
    toks, lgs = [tok], []
    for i in range({NEW - 1}):
        lg, state = dec(params, state, tok)
        tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
        lgs.append(np.asarray(lg))
        toks.append(tok)
        for n, c in state.cache.items():
            OUT[f"{{name}}/decode/{{n}}/{{i}}"] = np.asarray(c[:, :, :, {S} + i])
    OUT[name + "/decode/logits"], OUT[name + "/decode/tokens"] = np.stack(lgs), np.stack(toks, 1)
    for n, c in state.cache.items():
        OUT[f"{{name}}/decode/{{n}}"] = np.asarray(c)
'''


def _mesh(name: str) -> StackedMesh:
    d, m = MESHES[name]
    return StackedMesh(data=d, model=m)


def _port(name: str, tree, ref: dict) -> dict:
    """Prefill from the tokens; decode from the reference's prefill cache."""
    arch, mesh_name = CASES[name]
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    coll = CollectiveConfig(fsdp_mode="mcast")
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", S, B), collective=coll)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    out = {"prefill": prefill(params, {"tokens": torch.from_numpy(_tokens(name)).long()})}
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", S + NEW, B), collective=coll)
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    cache = {n: torch.from_numpy(np.pad(ref[f"{name}/int8/{n}"],
                                        [(0, 0)] * 3 + [(0, NEW), (0, 0)]))
             for n in ("k", "v", "ks", "vs")}
    state = ServeState(cache, torch.full((B,), S, dtype=torch.long))
    tok = torch.from_numpy(ref[name + "/logits"]).argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    out["decode"] = (torch.stack(lgs), torch.stack(toks, 1), state.cache)
    return out


@pytest.fixture(scope="module")
def case():
    trees = {a: random_tree(_cfg(a), 60 + i) for i, a in enumerate(ARCHS)}
    inputs = {f"{a}/{k}": v for a, tree in trees.items() for k, v in flatten(tree).items()}
    inputs.update({"tokens/" + name: _tokens(name) for name in CASES})
    ref = run_reference(_BODY, inputs)
    port = {name: _port(name, trees[CASES[name][0]], ref) for name in CASES}
    return dict(ref=ref, port=port)


def _assert_int8_close(q, s, rq, rs, x, what: str) -> None:
    """The scales within 1e-5 relative; the int8 values equal but where
    the unquantised x lies within ``TIE`` of a rounding tie, where they are
    at most one apart."""
    np.testing.assert_allclose(s, rs, rtol=1e-5, atol=0, err_msg=what)
    frac = np.abs(x / rs - np.floor(x / rs) - 0.5)
    near = np.broadcast_to(frac < TIE, q.shape)
    diff = np.abs(q.astype(np.int32) - rq.astype(np.int32))
    assert np.all(diff[~near] == 0), (what, int(np.sum(diff[~near] != 0)))
    assert np.all(diff <= 1), what


@pytest.mark.parametrize("name", list(CASES))
def test_int8_prefill_matches_jax(case, name):
    ref, (logits, cache) = case["ref"], case["port"][name]["prefill"]
    np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=1e-5, rtol=0)
    assert cache["k"].dtype == torch.int8 and cache["ks"].dtype == torch.float32
    for n in ("k", "v"):
        _assert_int8_close(cache[n].numpy(), cache[n + "s"].numpy(), ref[f"{name}/int8/{n}"],
                           ref[f"{name}/int8/{n}s"], ref[f"{name}/bf16/{n}"], f"{name} {n}")


@pytest.mark.parametrize("name", list(CASES))
def test_int8_decode_matches_jax(case, name):
    """7 decode steps from the reference's int8 prefill cache: the same
    tokens; the prompt's positions untouched. While every row written so
    far equals the reference's, a step's new rows have their scales within
    1e-5 (relative) of the reference's and their int8 values equal, and its
    logits are within 1e-4; where a layer's new row lies one level apart
    (the f32 sums in another order rounding a near-tie to the neighbour),
    that layer's scales still within 1e-5, the layers above it and the
    steps after it see another cache: their logits within 0.1, the
    reference's own bound on an int8 cache's divergence from an exact one
    (tests/test_kv_int8.py)."""
    ref = case["ref"]
    lgs, toks, cache = case["port"][name]["decode"]
    np.testing.assert_array_equal(toks.numpy(), ref[name + "/decode/tokens"])
    for n in ("k", "v"):
        np.testing.assert_array_equal(cache[n].numpy()[..., :S, :],
                                      ref[f"{name}/decode/{n}"][..., :S, :])
    same = True
    for i in range(NEW - 1):
        if same:   # the step's input cache equals the reference's
            q = {n: cache[n].numpy()[:, :, :, S + i] for n in ("k", "v", "ks", "vs")}
            rq = {n: ref[f"{name}/decode/{n}/{i}"] for n in ("k", "v", "ks", "vs")}
            levels = {n: np.abs(q[n].astype(np.int32) - rq[n].astype(np.int32))
                      for n in ("k", "v")}
            apart = [layer for layer in range(q["k"].shape[0])
                     if any(levels[n][layer].max() for n in levels)]
            # every layer below the first whose new rows lie apart saw the
            # reference's inputs: its scales within 1e-5, its rows at most a
            # level apart (a near-tie rounded to the neighbour)
            upto = apart[0] + 1 if apart else q["k"].shape[0]
            for n in ("k", "v"):
                np.testing.assert_allclose(q[n + "s"][:upto], rq[n + "s"][:upto], rtol=1e-5,
                                           atol=0, err_msg=f"step {i} {n}")
                assert levels[n][:upto].max() <= 1, (i, n)
            same = not apart
        np.testing.assert_allclose(lgs[i].numpy(), ref[name + "/decode/logits"][i],
                                   atol=1e-4 if same else 0.1, rtol=0, err_msg=f"step {i}")

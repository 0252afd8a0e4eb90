"""The port's physical ``model`` axis against the JAX package's GSPMD
placement: tensor and sequence parallelism over ``model``, flash-decoding,
``serve_params_replicated``, checkpoints across dp x tp splits.

The reference runs in one subprocess with 8 fake CPU devices
(``run_reference``) on Auto meshes, started first; the port's runs go on
beside it, on ``StackedMesh(data=2, model=4)`` and ``(data=4, model=2)``:
R = 8 stacked ranks, rank d * tp + m.

- ``flash_decode_attention`` against the reference's under ``shard_map``,
  with and without ``window`` and ``softcap``: 1e-5.
- Reduced smollm-135m (4 heads over 2 kv heads: heads split and kv heads
  replicated at tp = 4, both split at tp = 2), granite-34b (MQA; at tp = 4
  its 2 heads do not split, attention runs whole on every tp rank) and
  yi-9b served against ``jit_prefill_step`` / ``jit_decode_step`` on the
  same mesh: prefill logits and cache 1e-5, decode logits 1e-4, the same
  tokens; the same with ``serve_params_replicated``; a cache whose length
  does not split over ``model`` (the plain decode at tp > 1) and a batch
  that does not split over dp (replicated).
- 3 training steps in every mode on ``(data=4, model=2)`` against
  ``jit_train_step`` (``tests/test_torch_train.py`` and
  ``tests/test_torch_dense_configs.py`` hold ``(data=2, model=4)``): loss
  1e-5, grad_norm 1e-4 relative, parameters 1e-5.
- A checkpoint saved on ``(2, 4)`` and restored on ``(4, 2)`` and ``(8,
  1)``, bitwise; the ring and matmul launches of a
  prefill and a decode step, counted on the CPU, against
  ``chip_smoke.tp_launches`` (the counts PERF.md predicts for phase 3f).
"""
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint.ckpt import host_arrays
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_model_config, reduced, replace)
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels import collective_matmul as M
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import attention as attn
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.fsdp import at_use
from test_torch_support import (REPO, flatten, one_torch_thread,  # noqa: F401
                                random_tree, run_reference)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("smollm-135m", "granite-34b", "yi-9b")
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
B, S, NEW = 8, 16, 8       # the decode cache S + NEW = 24 splits over tp = 2 and 4
# serving cases: name -> (arch, mesh, batch, cache length, serve_params_replicated)
SERVE = {f"{a}/{m}": (a, m, B, S + NEW, False) for a in ARCHS for m in MESHES}
SERVE.update({f"{a}/{m}/repl": (a, m, B, S + NEW, True) for a in ARCHS for m in MESHES})
SERVE["smollm-135m/2x4/odd-cache"] = ("smollm-135m", "2x4", B, S + NEW - 1, False)
SERVE["smollm-135m/4x2/batch2"] = ("smollm-135m", "4x2", 2, S + NEW, False)
TRAIN_SHAPE = ShapeConfig("t", "train", 64, 8)
STEPS = 3
# flash-decoding: (B, H, KV, S, hd) and the variants
FD = (8, 4, 2, 32, 16)
FD_CASES = {"plain": (None, None), "window": (7, None), "softcap": (None, 5.0),
            "both": (7, 5.0)}


def _cfg(arch: str):
    return reduced(get_model_config(arch))


def _tokens(name: str) -> np.ndarray:
    arch, _, b, _, _ = SERVE[name]
    return np.random.default_rng(list(SERVE).index(name)).integers(
        0, _cfg(arch).vocab_size, (b, S)).astype(np.int32)


def _fd_inputs() -> dict:
    b, h, kv, s, hd = FD
    rng = np.random.default_rng(5)
    return {"fd/q": rng.standard_normal((b, h, hd)).astype(np.float32),
            "fd/k": rng.standard_normal((b, kv, s, hd)).astype(np.float32),
            "fd/v": rng.standard_normal((b, kv, s, hd)).astype(np.float32),
            "fd/pos": rng.integers(0, s, (b,)).astype(np.int32)}


_BODY = f'''
import jax.numpy as jnp
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced)
from repro.data import SyntheticPipeline
from repro.models.attention import flash_decode_attention
from repro.optim import adamw
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
from repro.runtime.train_loop import TrainState, jit_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        OUT[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

meshes = {{name: ref_mesh(shape, ("data", "model")) for name, shape in {MESHES}.items()}}
for name, mesh in meshes.items():
    for case, (window, softcap) in {FD_CASES}.items():
        out = flash_decode_attention(mesh, jnp.asarray(IN["fd/q"]), jnp.asarray(IN["fd/k"]),
                                     jnp.asarray(IN["fd/v"]), jnp.asarray(IN["fd/pos"]),
                                     window=window, softcap=softcap)
        OUT[f"fd/{{name}}/{{case}}"] = np.asarray(out)

for name, (arch, mesh_name, b, cache_len, repl) in {SERVE}.items():
    cfg = reduced(get_model_config(arch))
    mesh = meshes[mesh_name]
    params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/serve/"))
    coll = CollectiveConfig(fsdp_mode="xla", serve_params_replicated=repl)
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, b), collective=coll)
    _, step = jit_prefill_step(run, mesh)
    logits, cache = step(params, {{"tokens": IN[name + "/tokens"]}})
    OUT[name + "/logits"] = np.asarray(logits)
    for n in "kv":
        OUT[name + "/" + n] = np.asarray(cache[n])
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", cache_len, b), collective=coll)
    _, dec = jit_decode_step(run, mesh)
    cache = {{n: np.pad(OUT[name + "/" + n], [(0, 0)] * 3 + [(0, cache_len - {S}), (0, 0)])
             for n in "kv"}}
    state = ServeState(cache, np.full((b,), {S}, np.int32))
    tok = np.argmax(OUT[name + "/logits"], -1).astype(np.int32)
    toks, lgs = [tok], []
    for _ in range({NEW - 1}):
        lg, state = dec(params, state, tok)
        tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
        lgs.append(np.asarray(lg))
        toks.append(tok)
    OUT[name + "/decode/logits"], OUT[name + "/decode/tokens"] = np.stack(lgs), np.stack(toks, 1)

class Mesh42(MeshConfig):
    @property
    def shape(self): return (4, 2)
    @property
    def axes(self): return ("data", "model")

cfg = reduced(get_model_config("smollm-135m"))
shape = ShapeConfig("t", "train", {TRAIN_SHAPE.seq_len}, {TRAIN_SHAPE.global_batch})
pipe = SyntheticPipeline(cfg, shape)
run = RunConfig(model=cfg, shape=shape, mesh=Mesh42(), train=TrainConfig(steps=5),
                collective=CollectiveConfig(fsdp_mode="xla", n_chains=2))
_, jstep = jit_train_step(run, meshes["4x2"])
params = jax.tree.map(jnp.asarray, unflatten(IN, "train/"))
state = TrainState(params, adamw.init(params))
for i in range({STEPS}):
    state, m = jstep(state, pipe.next_batch(i))
    for key in ("loss", "grad_norm"):
        OUT[f"train/{{key}}{{i}}"] = np.asarray(m[key])
put("train/params/", state.params)
'''


def _mesh(name: str) -> StackedMesh:
    d, m = MESHES[name]
    return StackedMesh(data=d, model=m)


def _port_serving(name: str, tree) -> dict:
    arch, mesh_name, b, cache_len, repl = SERVE[name]
    cfg, mesh = _cfg(arch), _mesh(mesh_name)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    coll = CollectiveConfig(fsdp_mode="xla", serve_params_replicated=repl)
    tokens = torch.from_numpy(_tokens(name)).long()
    out = {}
    for mode in MODES:
        run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", S, b),
                        collective=replace(coll, fsdp_mode=mode))
        _, _, prefill = make_prefill_step(run, mesh, device="cpu")
        out[mode] = prefill(params, {"tokens": tokens})
    logits, cache = out["xla"]
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", cache_len, b), collective=coll)
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    state = ServeState({n: F.pad(c, (0, 0, 0, cache_len - S)) for n, c in cache.items()},
                       torch.full((b,), S, dtype=torch.long))
    tok = logits.argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    out["decode"] = (torch.stack(lgs), torch.stack(toks, 1))
    _, _, prefill = make_prefill_step(RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", S, b),
                                                collective=coll), mesh, device="cpu")
    out["greedy"] = greedy_generate(prefill, decode, params, tokens, NEW, cache_len)
    return out


def _port_training(tree) -> dict:
    cfg, mesh = _cfg("smollm-135m"), _mesh("4x2")
    out = {}
    for mode in MODES:
        run = RunConfig(model=cfg, shape=TRAIN_SHAPE, train=TrainConfig(steps=5),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, _, step = make_train_step(run, mesh, device="cpu")
        state = init_state(run, mesh, tree, device="cpu")
        pipe = SyntheticPipeline(cfg, TRAIN_SHAPE, device="cpu")
        metrics = []
        for i in range(STEPS):
            state, m = step(state, pipe.next_batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                         MeshConfig()))
        out[mode] = (metrics, params)
    return out


@pytest.fixture(scope="module")
def case():
    serve_trees = {a: random_tree(_cfg(a), 30 + i) for i, a in enumerate(ARCHS)}
    train_tree = random_tree(_cfg("smollm-135m"), 40)
    inputs = _fd_inputs()
    for a, tree in serve_trees.items():
        inputs.update({f"{a}/serve/{k}": v for k, v in flatten(tree).items()})
    inputs.update({f"train/{k}": v for k, v in flatten(train_tree).items()})
    inputs.update({name + "/tokens": _tokens(name) for name in SERVE})
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, _BODY, inputs)
        port = {name: _port_serving(name, serve_trees[SERVE[name][0]]) for name in SERVE}
        port["train"] = _port_training(train_tree)
        return dict(ref=ref.result(), port=port)


# ------------------------------------------------------------- flash-decoding


def _fd_port(mesh_name: str, window, softcap) -> torch.Tensor:
    """The port's flash-decoding on the stacked layout of ``mesh_name``: q
    on every shard, the cache's rows over dp and positions over ``model``."""
    d, m = MESHES[mesh_name]
    ins = {k: torch.from_numpy(v) for k, v in _fd_inputs().items()}
    b, h, kv, s, hd = FD
    q = ins["fd/q"].view(d, 1, b // d, h, hd).expand(d, m, b // d, h, hd)
    k, v = (ins[n].view(d, b // d, kv, m, s // m, hd).permute(0, 3, 1, 2, 4, 5)
            for n in ("fd/k", "fd/v"))
    pos = ins["fd/pos"].long().view(d, 1, b // d).expand(d, m, b // d)
    out = attn.flash_decode_attention(q, k, v, pos, window=window, softcap=softcap)
    assert torch.equal(out, out[:, :1].expand_as(out))   # every shard the merged output
    return out[:, 0].reshape(b, h, hd)


@pytest.mark.parametrize("variant", list(FD_CASES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_flash_decode_matches_jax(case, mesh_name, variant):
    window, softcap = FD_CASES[variant]
    got = _fd_port(mesh_name, window, softcap)
    np.testing.assert_allclose(got.numpy(), case["ref"][f"fd/{mesh_name}/{variant}"],
                               atol=1e-5, rtol=0)
    ins = {k: torch.from_numpy(v) for k, v in _fd_inputs().items()}
    plain = attn.plain_decode_attention(ins["fd/q"], ins["fd/k"], ins["fd/v"],
                                        ins["fd/pos"].long(), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------------------------- serving


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_matches_jax(case, name, mode):
    arch, _, b, _, _ = SERVE[name]
    cfg, ref = _cfg(arch), case["ref"]
    logits, cache = case["port"][name][mode]
    assert logits.shape == (b, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref[name + "/logits"], atol=1e-5, rtol=0)
    for n in ("k", "v"):
        assert cache[n].shape == (cfg.num_layers, b, cfg.num_kv_heads, S, cfg.head_dim)
        np.testing.assert_allclose(cache[n].numpy(), ref[f"{name}/{n}"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(SERVE))
def test_decode_and_greedy_match_jax(case, name):
    """7 decode steps from the prefill's cache: the reference's tokens,
    logits within 1e-4; greedy generation gives those tokens."""
    ref, port = case["ref"], case["port"][name]
    lgs, toks = port["decode"]
    np.testing.assert_array_equal(toks.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(lgs.numpy(), ref[name + "/decode/logits"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(port["greedy"][:, S:].numpy(), ref[name + "/decode/tokens"])


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_modes_agree_bitwise(case, name):
    base_logits, base_cache = case["port"][name]["xla"]
    for mode in MODES:
        logits, cache = case["port"][name][mode]
        assert torch.equal(logits, base_logits), mode
        assert all(torch.equal(cache[n], base_cache[n]) for n in cache), mode


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("mode", MODES)
def test_train_steps_match_jax_on_4x2(case, mode):
    ref = case["ref"]
    metrics, params = case["port"]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"train/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"train/grad_norm{i}"]), rel=1e-4), i
    for key, a in params.items():
        np.testing.assert_allclose(a, ref[f"train/params/{key}"], atol=1e-5, rtol=0,
                                   err_msg=key)


def test_train_modes_agree_bitwise_on_the_first_loss(case):
    first = {mode: run[0][0]["loss"] for mode, run in case["port"]["train"].items()}
    assert len(set(first.values())) == 1, first


# ------------------------------------------------------------- checkpoints


def test_checkpoint_across_dp_tp_splits(tmp_path):
    """A state stepped once on (data=2, model=4), saved, restored on (4, 2),
    (8, 1) and (2, 4): every stored array bitwise, and each restored state
    in its mesh's layout (wq: R = 8 ranks of (D / dp, H hd / tp))."""
    cfg = _cfg("smollm-135m")
    shape = ShapeConfig("t", "train", 32, 8)
    run = RunConfig(model=cfg, shape=shape, collective=CollectiveConfig(fsdp_mode="mcast"))
    old = StackedMesh(data=2, model=4)
    _, _, step = make_train_step(run, old, device="cpu")
    state = init_state(run, old, random_tree(cfg, 3), device="cpu")
    state, _ = step(state, SyntheticPipeline(cfg, shape, device="cpu").next_batch(0))
    save(state, str(tmp_path), 1)
    want = host_arrays(state)
    for d, m in ((4, 2), (8, 1), (2, 4)):
        mesh = StackedMesh(data=d, model=m)
        like = init_state(run, mesh, random_tree(cfg, 4), device="cpu")
        back, _ = restore(str(tmp_path), 1, like, mesh=mesh, mesh_cfg=MeshConfig())
        got = host_arrays(back)
        assert got.keys() == want.keys()
        for key, (a, dtype) in want.items():
            assert got[key][1] == dtype, key
            np.testing.assert_array_equal(got[key][0], a, err_msg=f"{key} on {mesh}")
        wq = at_use(back.params, mesh.n_ranks, ("data",))["blocks"]["attn"]["wq"].local
        assert wq.shape == (8, cfg.num_layers, cfg.d_model // d,
                            cfg.num_heads * cfg.head_dim // m)


# ----------------------------------------------------------- launch counts


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Spy:
    """Counts the calls of the ring gather, its transpose and the matmul: on
    the card each is one launch (a schedule of at most 128 entries)."""

    def __init__(self, monkeypatch):
        self.counts = {"ring_allgather": 0, "ring_allgather_transpose": 0, "matmul": 0}
        for module, name in ((C, "ring_allgather"), (C, "ring_allgather_transpose"),
                             (M, "matmul")):
            monkeypatch.setattr(module, name, self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        def spy(*args, **kw):
            self.counts[name] += 1
            return fn(*args, **kw)
        return spy

    def take(self) -> dict:
        out = dict(self.counts)
        self.counts = dict.fromkeys(self.counts, 0)
        return out


@pytest.mark.parametrize("mode,repl", [("xla", False), ("mcast", False), ("mcast_bcast", False),
                                       ("mcast", True)])
def test_launches_match_the_prediction(monkeypatch, mode, repl):
    """yi-9b's attention (32 heads over 4 kv heads: both split at tp = 4)
    at a small width and 3 layers on (data=2, model=4): the launches of a
    prefill and of a decode step are ``chip_smoke.tp_launches``'."""
    smoke = _chip_smoke()
    cfg = replace(_cfg("yi-9b"), num_layers=3, num_heads=32, num_kv_heads=4, head_dim=4)
    mesh = StackedMesh(data=2, model=4)
    params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                             dtype=torch.float32, device="cpu")
    coll = CollectiveConfig(fsdp_mode=mode, serve_params_replicated=repl)
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", S, B), collective=coll)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    tokens = torch.zeros(B, S, dtype=torch.long)
    prefill(params, {"tokens": tokens})   # the serving layout is made once, outside the counts
    spy = _Spy(monkeypatch)
    _, cache = prefill(params, {"tokens": tokens})
    got_prefill = spy.take()
    state = ServeState({n: F.pad(c, (0, 0, 0, NEW)) for n, c in cache.items()},
                       torch.full((B,), S, dtype=torch.long))
    decode(params, state, torch.zeros(B, dtype=torch.long))
    got_decode = spy.take()
    assert got_prefill == smoke.tp_launches(cfg, mesh, mode, "prefill", replicated=repl)
    assert got_decode == smoke.tp_launches(cfg, mesh, mode, "decode", replicated=repl)

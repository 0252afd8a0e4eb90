"""The port's sub-quadratic families, rwkv6-7b (RWKV6) and
recurrentgemma-9b (the hybrid: RG-LRU and local attention), reduced and in
f32, against the JAX package's: the WKV, the scan, the conv and the ring
decode attention in-process on one device; the blocks; serving on an Auto
``(data=8, model=1)`` mesh in every mode (``jit_prefill_step``; the rwkv
decode against ``jit_decode_step`` from the prefill's states; greedy
generation against the reference's token-by-token ``greedy_generate``,
which decodes the prompt, including the hybrid's ring-window handoff);
training against ``jit_train_step`` on the same mesh in every mode; and
checkpoints crossing between the packages.

The mesh references run in one subprocess with 8 fake CPU devices
(``run_reference``), started first; the port's runs go on beside it.
Tolerances: the WKV and the blocks within 1e-4 (f32 sums over chunks in
another order), the scan, the conv and the ring attention within 1e-5;
logits within 1e-4, the same tokens; the caches within 1e-4; training loss
within 1e-5 and grad_norm within 1e-4, relative, parameters within 1e-5.
The port's prefill logits and first-step losses are bitwise equal across
its modes.

The reduced hybrid is served at 5 layers (one (rec, rec, attn) group and
two trailing rec layers; window 32) and trained at 3, where its one-layer
``tail_rec`` is in the tree and no pass applies it.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build_model
from repro.models import rglru as ref_rglru
from repro.models import rwkv as ref_rwkv
from repro_torch import bridge
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint.ckpt import host_arrays
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_model_config, reduced, replace)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import attention, rglru, rwkv
from repro_torch.models import transformer
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding import specs
from repro_torch.sharding.fsdp import at_use
from test_torch_support import (flatten, one_torch_thread,  # noqa: F401
                                run_reference, serve_run)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("rwkv6-7b", "recurrentgemma-9b")
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
B, S = 8, 24                    # serving: batch, prompt
SHAPE = ShapeConfig("t", "train", 32, 8)
STEPS = 2
# greedy generation against the reference's token-by-token decode: (prompt,
# new tokens, cache length); the hybrid's window is 32 (reduced)
GREEDY = {"long": (40, 6, 46),      # a prompt longer than the window
          "short": (24, 6, 30),     # shorter: a ring of min(window, 30) slots
          "wrap": (24, 16, 40)}     # generation past slot 31 wraps the ring
# the leaves that are zeros or ones at init, drawn here so they are exercised
_VECTORS = ("ln", "ln1", "ln2", "final_ln", "conv_b", "lru_a_bias", "lru_x_bias",
            "ln_x_bias")


def serve_cfg(arch: str):
    return reduced(get_model_config(arch), layers=5 if arch == "recurrentgemma-9b" else None)


def train_cfg(arch: str):
    return reduced(get_model_config(arch))


def ref_cfg(cfg):
    return ref_reduced(ref_model_config(cfg.name[:-len("-smoke")]), layers=cfg.num_layers)


def tree_of(cfg, seed: int) -> dict:
    """A reduced parameter tree with its norm scales and biases drawn too."""
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


def _tokens(arch: str, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed + len(arch) + s).integers(
        0, 256, (B, s)).astype(np.int32)


# ----------------------------------------------------------- the pieces


def _wkv_case(b, s, h, hd, seed, decay_scale=1.0):
    """``tests/test_rwkv_wkv.py``'s inputs."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) for _ in range(3))
    lw = -rng.uniform(0.001, decay_scale, (b, s, h, hd)).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.5).astype(np.float32)
    return r, k, v, lw, u


@pytest.mark.parametrize("chunk", [4, 16, 64])
@pytest.mark.parametrize("s", [16, 60, 128])
def test_wkv_matches_jax(chunk, s):
    """``wkv_chunked`` and ``wkv_recurrent`` against the reference's, output
    and final state, over ``tests/test_rwkv_wkv.py``'s chunks and lengths."""
    case = _wkv_case(2, s, 2, 8, seed=chunk + s)
    t = [torch.from_numpy(a) for a in case]
    j = [jnp.asarray(a) for a in case]
    for got, want in ((rwkv.wkv_chunked(*t, chunk), ref_rwkv.wkv_chunked(*j, chunk)),
                      (rwkv.wkv_recurrent(*t), ref_rwkv.wkv_recurrent(*j))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_wkv_streaming_and_per_row_bonus():
    """Recurrent decode from the chunked prefill's state is the whole
    recurrence (the reference's ``test_state_carry_streaming``), and a bonus
    given per row equals the shared one."""
    r, k, v, lw, u = (torch.from_numpy(a) for a in _wkv_case(1, 32, 2, 8, seed=7))
    o_full, s_full = rwkv.wkv_recurrent(r, k, v, lw, u)
    _, s_pre = rwkv.wkv_chunked(r[:, :24], k[:, :24], v[:, :24], lw[:, :24], u, 8)
    o_tail, s_tail = rwkv.wkv_recurrent(r[:, 24:], k[:, 24:], v[:, 24:], lw[:, 24:], u,
                                        S0=s_pre)
    np.testing.assert_allclose(o_tail.numpy(), o_full[:, 24:].numpy(), atol=1e-4)
    np.testing.assert_allclose(s_tail.numpy(), s_full.numpy(), atol=1e-4)
    rows = u.expand(1, *u.shape)
    for fn in (lambda uu: rwkv.wkv_chunked(r, k, v, lw, uu, 8),
               lambda uu: rwkv.wkv_recurrent(r, k, v, lw, uu)):
        assert all(torch.equal(a, b) for a, b in zip(fn(u), fn(rows)))


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(s, with_h0):
    """The doubling scan against ``jax.lax.associative_scan``'s, with the
    initial state folded into step 0 or none."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (3, s, 8)).astype(np.float32)
    b = rng.standard_normal((3, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((3, 8)).astype(np.float32) if with_h0 else None
    h, last = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                               None if h0 is None else torch.from_numpy(h0))
    rh, rlast = ref_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                     None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), atol=1e-5, rtol=0)


def test_rglru_scan_is_log_depth():
    """ceil(log2 S) rounds of cat: the op count does not grow with S."""
    calls = []
    real = torch.cat

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    torch.cat = spy
    try:
        rglru.rglru_scan(torch.ones(1, 512, 4), torch.ones(1, 512, 4))
    finally:
        torch.cat = real
    assert len(calls) == 2 * 9 - 1


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_matches_jax(with_tail):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_tail else None
    y, nt = rglru.causal_conv1d(torch.from_numpy(x)[None], torch.from_numpy(w)[None],
                                torch.from_numpy(b)[None],
                                None if tail is None else torch.from_numpy(tail)[None])
    ry, rnt = ref_rglru.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      None if tail is None else jnp.asarray(tail))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(ry), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(nt[0].numpy(), np.asarray(rnt))


def test_ring_decode_attention_matches_jax():
    """A ring of 8 slots that has wrapped (positions 0..13 written, each at
    slot p % 8), window 6, one query group of 4 heads over 2 kv heads."""
    rng = np.random.default_rng(5)
    w, pos = 8, np.array([13, 9, 3], np.int32)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 2, w, 16)).astype(np.float32) for _ in range(2))
    idx = np.arange(w)
    abs_pos = (pos[:, None] - ((pos[:, None] - idx[None]) % w)).astype(np.int32)
    got = attention.ring_decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, abs_pos,
                                                                           pos)), 6)
    want = ref_attn.ring_decode_attention(*(jnp.asarray(a) for a in (q, kc, vc, abs_pos, pos)),
                                          6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _layer(tree: dict, i: int = 0):
    """Layer i of a stacked numpy tree: (jax tree, port tree with one rank)."""
    def take(node):
        return {k: take(v) if isinstance(v, dict) else v[i] for k, v in node.items()}
    layer = take(tree)
    port = jax.tree.map(lambda a: torch.from_numpy(np.ascontiguousarray(a))[None], layer)
    return jax.tree.map(jnp.asarray, layer), port


def test_rwkv_block_matches_jax():
    """One RWKV6 block: the chunked prefill from no state (seq 40, chunk 16,
    two chunks and a padded one), then a decode step from its state."""
    cfg = train_cfg("rwkv6-7b")
    jp, tp = _layer(tree_of(cfg, 3)["blocks"])
    x = np.random.default_rng(4).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    x1 = np.random.default_rng(5).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rc = ref_cfg(cfg)
    want, wst = ref_rwkv.rwkv_block_apply(jp, jnp.asarray(x), rc, state=None, chunked=True)
    got, gst = rwkv.rwkv_block_apply(tp, torch.from_numpy(x)[None], cfg, state=None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-4, rtol=0)
    for k in ("wkv", "tm_x", "cm_x"):
        np.testing.assert_allclose(gst[k][0].numpy(), np.asarray(wst[k]), atol=1e-4, rtol=0)
    want1, wst1 = ref_rwkv.rwkv_block_apply(jp, jnp.asarray(x1), rc, state=wst, chunked=False)
    got1, gst1 = rwkv.rwkv_block_apply(tp, torch.from_numpy(x1)[None], cfg, state=gst,
                                       chunked=False)
    np.testing.assert_allclose(got1[0].numpy(), np.asarray(want1), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gst1["wkv"][0].numpy(), np.asarray(wst1["wkv"]), atol=1e-4)
    with pytest.raises(NotImplementedError, match="chunked WKV"):
        rwkv.rwkv_block_apply(tp, torch.from_numpy(x)[None], cfg, state=gst, chunked=True)


def test_rec_block_matches_jax():
    """Griffin's recurrent block from no state (seq 40), then 3 steps from
    its state."""
    cfg = serve_cfg("recurrentgemma-9b")
    jp, tp = _layer(tree_of(cfg, 6)["grp_rec_a"]["rec"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    x3 = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    rc = ref_cfg(cfg)
    want, wst = ref_rglru.rec_block_apply(jp, jnp.asarray(x), rc)
    got, gst = rglru.rec_block_apply(tp, torch.from_numpy(x)[None], cfg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want3, wst3 = ref_rglru.rec_block_apply(jp, jnp.asarray(x3), rc, state=wst)
    got3, gst3 = rglru.rec_block_apply(tp, torch.from_numpy(x3)[None], cfg, state=gst)
    np.testing.assert_allclose(got3[0].numpy(), np.asarray(want3), atol=1e-5, rtol=0)
    for k in ("h", "conv"):
        np.testing.assert_allclose(gst3[k][0].numpy(), np.asarray(wst3[k]), atol=1e-5, rtol=0)


# --------------------------------------------- configs, trees, specs, counts


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_trees_equal_reference(arch):
    """The config and its reduced form are the reference's; the parameter
    tree has the reference's leaves, shapes and dtypes (``init_params``),
    the one-layer ``tail_rec`` of a 3-layer hybrid included; the analytic
    count is the reference's, full and reduced."""
    from repro.models.model_builder import count_params_analytic as ref_count
    from repro_torch.models import count_params_analytic
    full, ref_full = get_model_config(arch), ref_model_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert count_params_analytic(full) == ref_count(ref_full)
    assert full.n_params() == {"rwkv6-7b": 7_576_616_960,
                               "recurrentgemma-9b": 9_396_305_920}[arch]
    for cfg in (train_cfg(arch), serve_cfg(arch)):
        rc = ref_cfg(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rc)
        assert count_params_analytic(cfg) == ref_count(rc)
        rc16 = dataclasses.replace(rc, param_dtype="bfloat16")
        want = flatten(jax.eval_shape(ref_build_model(rc16).init_params,
                                      jax.random.PRNGKey(0)))
        port = flatten(bridge.to_torch(bridge.random_params(cfg, 0), None, MeshConfig(),
                                       dtype=torch.bfloat16, device="cpu"))
        assert sorted(port) == sorted(want)
        for key, leaf in port.items():
            w = want[key]
            assert tuple(leaf.local.shape[1:]) == w.shape, key
            assert str(leaf.local.dtype).split(".")[-1] == str(w.dtype), key
    tail = flatten(bridge.random_params(train_cfg(arch), 0))
    if arch == "recurrentgemma-9b":
        assert tail["tail_rec/rec/w_out"].shape[0] == 1     # 3 layers: no trailing layer


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """Every leaf's spec is the reference's ``param_pspecs`` at ``(8, 1)``
    and ``(2, 4)``; every leaf of ``init_cache`` has the reference's shape and
    ``cache_pspecs``' spec. At
    ``(8, 1)`` an rwkv layer has 12 dp-sharded leaves, a hybrid rec layer 8
    and an attention layer 7 (the launches of #1 a layer)."""
    from types import SimpleNamespace

    from repro.configs import MeshConfig as RefMeshConfig
    from repro.sharding import specs as ref_specs
    cfg = serve_cfg(arch)
    tree = bridge.random_params(cfg, 0)
    norm = lambda s: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)
    for axes in ({"data": 8, "model": 1}, {"data": 2, "model": 4}):
        got = flatten(specs.param_pspecs(tree, StackedMesh(**axes), MeshConfig()))
        want = flatten(ref_specs.param_pspecs(tree, SimpleNamespace(shape=dict(axes)),
                                              RefMeshConfig()))
        for key, spec in got.items():
            assert norm(spec) == norm(tuple(want[key])), (axes, key)
    got = flatten(specs.param_pspecs(tree, StackedMesh(data=8, model=1), MeshConfig()))
    sharded = {k for k, s in got.items() if specs.is_sharded(s, ("data",))}
    if arch == "rwkv6-7b":
        assert len([k for k in sharded if k.startswith("blocks/")]) == 12
    else:
        for group, n in (("grp_rec_a", 8), ("grp_rec_b", 8), ("grp_attn", 7), ("tail_rec", 8)):
            assert len([k for k in sharded if k.startswith(group + "/")]) == n
    cache = ref_build_model(ref_cfg(cfg)).init_cache(B, 40)
    api_cache = (transformer.rwkv_init_cache if arch == "rwkv6-7b" else
                 transformer.hybrid_init_cache)(cfg, B, 40, torch.float32, "cpu")
    for axes in ({"data": 8, "model": 1}, {"data": 2, "model": 4}):
        want = flatten(ref_specs.cache_pspecs(ref_cfg(cfg), cache,
                                              SimpleNamespace(shape=dict(axes)),
                                              RefMeshConfig(), 40))
        got = flatten(specs.cache_pspecs(cfg, api_cache, StackedMesh(**axes), MeshConfig()))
        assert sorted(got) == sorted(want)
        for key, spec in want.items():
            assert norm(got[key]) == norm(tuple(spec)), (axes, key)
            assert tuple(flatten(api_cache)[key].shape) == np.shape(flatten(cache)[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_device_params_layout_matches_to_torch(arch):
    """``device_params`` gives the leaves, specs, shapes and dtypes of
    ``to_torch(random_params(...))``, in the init distributions (the uniform
    leaves' means and ranges, the ones, the zeros)."""
    cfg = serve_cfg(arch)
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
        g, spec = leaf.local.float(), table[key]
        if spec.dist == "ones" or not spec.scale:
            assert torch.all(g == (1.0 if spec.dist == "ones" else 0.0)), key
        elif spec.dist == "uniform":
            lo, hi = spec.shift, spec.shift + spec.scale
            assert lo <= g.min().item() and g.max().item() <= hi, key
            assert g.mean().item() == pytest.approx((lo + hi) / 2, abs=0.1 * spec.scale), key
        else:
            assert g.std().item() == pytest.approx(spec.scale, rel=0.15), key


# -------------------------------------------------- the reference's runs

_BODY = f'''
import jax.numpy as jnp
from repro.checkpoint import restore, save
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced, replace)
from repro.data import SyntheticPipeline
from repro.models import build_model
from repro.optim import adamw
from repro.runtime import init_state
from repro.runtime.serve_loop import (ServeState, greedy_generate, jit_decode_step,
                                      jit_prefill_step)
from repro.runtime.train_loop import TrainState, jit_train_step, make_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        OUT[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32) if leaf.dtype == jnp.bfloat16
                                       else leaf)

class Mesh81(MeshConfig):
    @property
    def shape(self): return (8, 1)

mesh = ref_mesh((8, 1), ("data", "model"))
for arch in {ARCHS}:
    # serving on (8, 1)
    cfg = reduced(get_model_config(arch), layers=5 if arch == "recurrentgemma-9b" else None)
    params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/serve/"))
    tokens = IN[arch + "/tokens"]
    for mode in {MODES}:
        run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, step = jit_prefill_step(run, mesh)
        logits, cache = step(params, {{"tokens": tokens}})
        OUT[f"{{arch}}/{{mode}}/logits"] = np.asarray(logits)
        put(f"{{arch}}/{{mode}}/cache/", cache)
    if arch == "rwkv6-7b":
        # the states hold no sequence: decode continues from the prefill's
        run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + 6}, {B}))
        _, dec = jit_decode_step(run, mesh)
        cache = unflatten({{k: v for k, v in OUT.items()}}, f"{{arch}}/xla/cache/")
        state = ServeState(jax.tree.map(jnp.asarray, cache), np.full(({B},), {S}, np.int32))
        tok = np.argmax(OUT[f"{{arch}}/xla/logits"], -1).astype(np.int32)
        lgs = []
        for _ in range(5):
            lg, state = dec(params, state, tok)
            tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
            lgs.append(np.asarray(lg))
        OUT[arch + "/decode/logits"] = np.stack(lgs)
    # token-by-token generation, no mesh: the tokens of greedy_generate and
    # the logits of each position from the prompt's last on
    api = build_model(cfg)
    step = jax.jit(lambda p, c, t, pos: api.decode_fn(p, c, t, pos))
    for name, (s, new, cache_len) in {GREEDY}.items():
        prompt = jnp.asarray(IN[f"{{arch}}/greedy/{{name}}"])
        OUT[f"{{arch}}/greedy/{{name}}/tokens"] = np.asarray(
            greedy_generate(api, params, prompt, new, cache_len))
        cache = api.init_cache({B}, cache_len)
        tok, lgs = prompt[:, 0], []
        for t in range(1, s + new):
            lg, cache = step(params, cache, tok, jnp.full(({B},), t - 1, jnp.int32))
            tok = prompt[:, t] if t < s else jnp.argmax(lg, -1).astype(jnp.int32)
            if t >= s:
                lgs.append(np.asarray(lg))
        OUT[f"{{arch}}/greedy/{{name}}/logits"] = np.stack(lgs)

    # training on (8, 1) in every mode
    cfg = reduced(get_model_config(arch))
    shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
    pipe = SyntheticPipeline(cfg, shape)
    for mode in {MODES}:
        run = RunConfig(model=cfg, shape=shape, mesh=Mesh81(), train=TrainConfig(steps=5),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        try:
            _, jstep = jit_train_step(run, mesh)
            params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/train/"))
            state = TrainState(params, adamw.init(params))
            for i in range({STEPS}):
                state, m = jstep(state, pipe.next_batch(i))
                for name in ("loss", "grad_norm"):
                    OUT[f"{{arch}}/{{mode}}/{{name}}{{i}}"] = np.asarray(m[name])
            put(f"{{arch}}/{{mode}}/params/", state.params)
        except Exception as e:
            print(arch, mode, "failed:", repr(e)[:300], file=sys.stderr)

    # the same steps on one device, no mesh: the grad norms' yardstick
    _, _, one = make_train_step(RunConfig(model=cfg, shape=shape, train=TrainConfig(steps=5)),
                                None)
    one = jax.jit(one)
    params = jax.tree.map(jnp.asarray, unflatten(IN, arch + "/train/"))
    state = TrainState(params, adamw.init(params))
    for i in range({STEPS}):
        state, m = one(state, pipe.next_batch(i))
        OUT[f"{{arch}}/single/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
    put(f"{{arch}}/single/params/", state.params)

    # checkpoints: the reference's bf16 state saved; the port's restored
    bf16 = replace(cfg, param_dtype="bfloat16")
    state = init_state(RunConfig(model=bf16, shape=ShapeConfig("t", "train", 32, 8)), None,
                       jax.random.PRNGKey(0))
    save(state, str(IN[arch + "/ref_dir"]), 5)
    put(arch + "/ref_state/", state)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
    restored, manifest = restore(str(IN[arch + "/port_dir"]), 3, like)
    put(arch + "/port_restored/", restored)
'''


def _f32(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.view(np.uint16).astype(np.uint32).__lshift__(16).view(np.float32) \
        if dtype == "bfloat16" else a


def _serve(arch: str, tree) -> dict:
    cfg = serve_cfg(arch)
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(_tokens(arch, S)).long()
    out = {}
    for mode in MODES:
        _, _, prefill = make_prefill_step(serve_run(cfg, mode, B, S), mesh, device="cpu")
        out[mode] = prefill(params, {"tokens": tokens})
    for name, (s, new, cache_len) in GREEDY.items():
        prompt = torch.from_numpy(_tokens(arch, s, 1)).long()
        for mode in MODES:
            run = serve_run(cfg, mode, B, s)
            _, _, prefill = make_prefill_step(run, mesh, device="cpu")
            _, _, decode = make_decode_step(run, mesh, device="cpu")
            out[f"greedy/{name}/{mode}"] = greedy_generate(prefill, decode, params, prompt,
                                                           new, cache_len)
        # the logits of the xla run's prefill and decode steps
        run = serve_run(cfg, "xla", B, s)
        _, _, prefill = make_prefill_step(run, mesh, device="cpu")
        _, _, decode = make_decode_step(run, mesh, device="cpu")
        logits, pre = prefill(params, {"tokens": prompt})
        state = ServeState(transformer.decode_cache(cfg, pre, s, cache_len),
                           torch.full((B,), s, dtype=torch.long))
        lgs, tok = [logits], logits.argmax(-1)
        for _ in range(new - 1):
            lg, state = decode(params, state, tok)
            lgs.append(lg)
            tok = lg.argmax(-1)
        out[f"greedy/{name}/logits"] = torch.stack(lgs)
    if arch == "rwkv6-7b":
        logits, cache = out["xla"]
        _, _, decode = make_decode_step(serve_run(cfg, "mcast", B, S + 6, "decode"), mesh,
                                        device="cpu")
        state = ServeState({k: v.clone() for k, v in cache.items()},
                           torch.full((B,), S, dtype=torch.long))
        tok, lgs = logits.argmax(-1), []
        for _ in range(5):
            lg, state = decode(params, state, tok)
            tok = lg.argmax(-1)
            lgs.append(lg)
        out["decode"] = torch.stack(lgs)
    return out


def _train(arch: str, tree, mode: str, *, remat: str = "full", prefetch: bool = False,
           steps: int = STEPS):
    cfg = train_cfg(arch)
    mesh = StackedMesh(data=8, model=1)
    run = RunConfig(model=cfg, shape=SHAPE, train=TrainConfig(steps=5, remat=remat),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2, prefetch=prefetch))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    pipe = SyntheticPipeline(cfg, SHAPE, device="cpu")
    metrics = []
    for i in range(steps):
        state, m = step(state, pipe.next_batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                     MeshConfig()))
    return metrics, params


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The reference's serving, training and checkpoints in one subprocess,
    started first (the port's bf16 states saved before it); the port's
    serving and training beside it."""
    tmp = tmp_path_factory.mktemp("subquadratic")
    inputs, trees, port_states, dirs = {}, {}, {}, {}
    for i, arch in enumerate(ARCHS):
        trees[arch] = (tree_of(serve_cfg(arch), 10 + i), tree_of(train_cfg(arch), 20 + i))
        inputs.update({f"{arch}/serve/{k}": v for k, v in flatten(trees[arch][0]).items()})
        inputs.update({f"{arch}/train/{k}": v for k, v in flatten(trees[arch][1]).items()})
        inputs[arch + "/tokens"] = _tokens(arch, S)
        for name, (s, _, _) in GREEDY.items():
            inputs[f"{arch}/greedy/{name}"] = _tokens(arch, s, 1)
        dirs[arch] = {n: str(tmp / f"{arch}_{n}") for n in ("port_dir", "ref_dir")}
        inputs.update({f"{arch}/{n}": np.asarray(d) for n, d in dirs[arch].items()})
        bf16 = replace(train_cfg(arch), param_dtype="bfloat16")
        port_states[arch] = init_state(RunConfig(model=bf16, shape=ShapeConfig("t", "train",
                                                                               32, 8)),
                                       StackedMesh(data=8, model=1), tree_of(bf16, 30 + i),
                                       device="cpu")
        save(port_states[arch], dirs[arch]["port_dir"], 3)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, _BODY, inputs)
        port = {arch: dict(serve=_serve(arch, trees[arch][0]),
                           train={mode: _train(arch, trees[arch][1], mode) for mode in MODES})
                for arch in ARCHS}
        return dict(ref=ref.result(), port=port, trees=trees, states=port_states, dirs=dirs)


# --------------------------------------------------------------- serving


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(case, arch, mode):
    """Last-position logits and every cache leaf (the rwkv states; the
    hybrid's rec states, its window-clipped keys and values and its
    trailing layers' states) against the reference's prefill in the same
    mode; the logits bitwise the port's xla prefill's."""
    ref = case["ref"]
    cfg = serve_cfg(arch)
    logits, cache = case["port"][arch]["serve"][mode]
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref[f"{arch}/{mode}/logits"], atol=1e-4, rtol=0)
    assert torch.equal(logits, case["port"][arch]["serve"]["xla"][0])
    got = flatten(cache)
    want = {k[len(f"{arch}/{mode}/cache/"):]: v for k, v in ref.items()
            if k.startswith(f"{arch}/{mode}/cache/")}
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        np.testing.assert_allclose(a.numpy(), want[key], atol=1e-4, rtol=0, err_msg=key)


def test_rwkv_decode_matches_jax(case):
    """5 decode steps from the xla prefill's states (no handoff: they hold no
    sequence): the reference decode step's logits within 1e-4."""
    np.testing.assert_allclose(case["port"]["rwkv6-7b"]["serve"]["decode"].numpy(),
                               case["ref"]["rwkv6-7b/decode/logits"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(GREEDY))
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_matches_token_by_token_reference(case, arch, name):
    """Prefill then decode against the reference's ``greedy_generate``, which
    decodes the prompt one token at a time: the same tokens in every mode,
    and the logits of the prompt's last position and of each decode step
    within 1e-4. For the hybrid (window 32) the prefill's keys move into the
    decode rings by position: a 40-token prompt (longer than the window), a
    24-token one into 30 slots, and 16 new tokens that wrap the ring."""
    ref, port = case["ref"], case["port"][arch]["serve"]
    s = GREEDY[name][0]
    want = ref[f"{arch}/greedy/{name}/tokens"]
    for mode in MODES:
        out = port[f"greedy/{name}/{mode}"]
        np.testing.assert_array_equal(out.numpy(), want, err_msg=mode)
        assert out.shape[1] == s + GREEDY[name][1]
    np.testing.assert_allclose(port[f"greedy/{name}/logits"].numpy(),
                               ref[f"{arch}/greedy/{name}/logits"], atol=1e-4, rtol=0)


def test_hybrid_handoff_places_positions_by_slot():
    """``decode_cache`` writes prompt position p at slot p % slots: a
    40-position prompt clipped to the window's last 32 (positions 8..39),
    into 32 slots; a 24-position one into 30."""
    cfg = serve_cfg("recurrentgemma-9b")
    for s, cache_len, slots in ((40, 46, 32), (24, 30, 30)):
        m = min(s, 32)
        k = torch.arange(s - m, s, dtype=torch.float32).view(1, 1, 1, m, 1).expand(
            1, 2, 1, m, cfg.head_dim).contiguous()
        pre = {"rec_a": {}, "rec_b": {}, "attn_k": k, "attn_v": k, "tail": None}
        ring = transformer.decode_cache(cfg, pre, s, cache_len)["attn_k"]
        assert ring.shape[3] == slots
        for p in range(s - m, s):
            assert ring[0, 0, 0, p % slots, 0].item() == p


# --------------------------------------------------------------- training


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(case, arch, mode):
    """2 steps on (data=8, model=1) against ``jit_train_step`` in the same
    mode: loss within 1e-5, relative; then grad_norm within 1e-4, relative,
    and every parameter within 1e-5 (the hybrid's unused ``tail_rec`` moved
    by weight decay alone) of the reference's same steps on one device: on
    the mesh the reference's rwkv embedding gradient is off its own
    one-device one (grad_norm by 1.0e-4, ROADMAP §3)."""
    ref = case["ref"]
    key = f"{arch}/{mode}" if f"{arch}/{mode}/loss0" in ref else f"{arch}/xla"
    metrics, params = case["port"][arch]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{key}/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{arch}/single/grad_norm{i}"]),
                                               rel=1e-4), i
    for name, a in params.items():
        np.testing.assert_allclose(a, ref[f"{arch}/single/params/{name}"], atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_modes_agree_bitwise_on_the_first_loss(case, arch):
    runs = case["port"][arch]["train"]
    assert len({runs[mode][0][0]["loss"] for mode in MODES}) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_prefetch_leave_the_step_bitwise(case, arch):
    """The reference checkpoints these layers only for remat="full" and
    prefetches only the dense stack: "none", "dots" and prefetch give the
    losses, grad norms and parameters of the "full" step bitwise."""
    tree = case["trees"][arch][1]
    base = case["port"][arch]["train"]["mcast"]
    for remat, prefetch in (("none", False), ("dots", False), ("full", True)):
        metrics, params = _train(arch, tree, "mcast", remat=remat, prefetch=prefetch)
        assert [(m["loss"], m["grad_norm"]) for m in metrics] == \
            [(m["loss"], m["grad_norm"]) for m in base[0]], (remat, prefetch)
        for name, a in params.items():
            assert np.array_equal(a, base[1][name]), (remat, prefetch, name)


def test_unused_tail_rec_has_zero_gradient(case):
    """A 3-layer hybrid's ``tail_rec`` (one layer, applied by no pass) is in
    the train state and moves only by weight decay: (1 - lr * wd) per step."""
    tree = case["trees"]["recurrentgemma-9b"][1]
    _, params = case["port"]["recurrentgemma-9b"]["train"]["mcast"]
    before = flatten(tree)["tail_rec/rec/w_out"]
    after = params["tail_rec/rec/w_out"]
    assert not np.array_equal(before, after)
    ratio = after[before != 0] / before[before != 0]
    assert np.allclose(ratio, ratio.flat[0], rtol=1e-6) and ratio.flat[0] < 1


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_port(case, arch):
    """The reference's bf16 state (the hybrid's groups and its one-layer
    ``tail_rec``), saved with no mesh, restored into the port's ``(data=8,
    model=1)`` structure: every array bitwise, the f32 vectors f32."""
    ref = case["ref"]
    restored, manifest = restore(case["dirs"][arch]["ref_dir"], 5, case["states"][arch],
                                 mesh=None)
    got = host_arrays(restored)
    assert list(got) == manifest["keys"]
    f32 = "params/blocks/mu" if arch == "rwkv6-7b" else "params/tail_rec/rec/lru_lam"
    assert got[f32][1] == "float32"
    for key, (a, dtype) in got.items():
        np.testing.assert_array_equal(_f32(a, dtype), ref[f"{arch}/ref_state/" + key],
                                      err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(case, arch):
    ref = case["ref"]
    for key, (a, dtype) in host_arrays(case["states"][arch]).items():
        np.testing.assert_array_equal(ref[f"{arch}/port_restored/" + key], _f32(a, dtype),
                                      err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_take_the_subquadratic_archs(arch, tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--fsdp-mode", "mcast"])
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
                "--seq", "32", "--fsdp-mode", "mcast_bcast", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu" in out and "8 prompt + 3 new tokens" in out
    assert "step     1 loss" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_sim_profiles_match_reference(arch):
    """``core/train_sim``'s layer profiles, which take the analytic parameter
    count, equal the reference's for both configs."""
    from repro.core import train_sim as ref_ts
    from repro_torch.core import train_sim as ts
    for kw in (dict(dp=16), dict(dp=8, tp=2, grad_accum=4, remat="none")):
        got = ts.derive_layer_profiles(arch, **kw)
        want = ref_ts.derive_layer_profiles(arch, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert dataclasses.astuple(g) == dataclasses.astuple(w), (arch, kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_launches_match_chip_smoke(monkeypatch, arch):
    """``chip_smoke.subq_launches`` (the counts phases 3g and 4g assert on
    the card) is what the code launches: a prefill of the reduced config
    at full depth (32 / 38 layers) in bf16 on (8, 1), a decode step, and a
    train step at 4g's depth and mesh. On the card each gather, transpose
    and product is one launch (a schedule of at most 128 entries)."""
    import importlib.util
    import os

    from repro_torch.core import collectives as C
    from repro_torch.kernels import collective_matmul as M
    from test_torch_support import REPO
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    counts = dict.fromkeys(("ring_allgather", "ring_allgather_transpose", "matmul",
                            "matmul_f32"), 0)

    def spy(name, fn):
        def wrapped(*args, **kw):
            key = name if name != "matmul" or args[0].dtype == torch.bfloat16 else "matmul_f32"
            counts[key] += 1
            return fn(*args, **kw)
        return wrapped

    for module, name in ((C, "ring_allgather"), (C, "ring_allgather_transpose"), (M, "matmul")):
        monkeypatch.setattr(module, name, spy(name, getattr(module, name)))

    def take():
        out = dict(counts)
        counts.update(dict.fromkeys(counts, 0))
        return out

    full = get_model_config(arch)
    cfg = replace(reduced(full, layers=full.num_layers), param_dtype="bfloat16",
                  compute_dtype="bfloat16")
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                             dtype=torch.bfloat16, device="cpu")
    run = serve_run(cfg, "mcast", B, 16)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    tokens = torch.from_numpy(_tokens(arch, 16)).long()
    take()
    logits, pre = prefill(params, {"tokens": tokens})
    assert take() == cs.subq_launches(cfg, train=False)
    state = ServeState(transformer.decode_cache(cfg, pre, 16, 17), torch.full((B,), 16))
    decode(params, state, logits.argmax(-1))
    assert take() == dict(cs.subq_launches(cfg, train=False), ring_allgather=0)
    tcfg = replace(cfg, num_layers=cs.SUBQ_TRAIN_LAYERS[arch])
    tmesh = cs.SUBQ_TRAIN_MESH[arch]
    shape = ShapeConfig("t", "train", 32, 16)
    trun = RunConfig(model=tcfg, shape=shape, collective=CollectiveConfig(fsdp_mode="mcast"))
    _, _, step = make_train_step(trun, tmesh, device="cpu")
    tstate = init_state(trun, tmesh, bridge.random_params(tcfg, 0), device="cpu")
    take()
    step(tstate, SyntheticPipeline(tcfg, shape, device="cpu").next_batch(0))
    assert take() == cs.subq_launches(tcfg, train=True)

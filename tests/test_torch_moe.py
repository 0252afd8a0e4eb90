"""The port's MoE family (deepseek-moe-16b, reduced, f32) against the JAX
package's: ``moe_apply`` alone, the serving path on an Auto ``(data=8,
model=1)`` mesh, the training path on an Auto ``(data=2, model=4)`` mesh
(the configuration of the reference's ``test_moe_train_multidev``) against
the port's 2 dp ranks (the port's EP over a physical ``model`` axis is
``tests/test_torch_ep.py``'s), and checkpoints crossing between the
packages.

``moe_apply`` runs in-process on one device, as the reference's own MoE
tests run it; the mesh references run in one subprocess with 8 fake CPU
devices (``run_reference``). Tolerances: ``moe_apply``'s output and its
gradients within 1e-5, its aux metrics within 1e-6 and the drop fraction
equal; prefill logits and KV cache within 1e-5, decode logits within 1e-4,
the same tokens; training loss and the ``moe_*`` metrics within 1e-5,
grad_norm within 1e-4 relative, parameters within 1e-5 (f32 sums in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.models import moe as ref_moe
from repro_torch import bridge
from repro_torch.checkpoint import restore, save
from repro_torch.checkpoint.ckpt import host_arrays
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_model_config, reduced, replace)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import moe
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding import specs
from repro_torch.sharding.ctx import ShardCtx, use_ctx
from repro_torch.sharding.fsdp import at_use
from test_torch_support import (flatten, one_torch_thread,  # noqa: F401
                                run_reference, serve_run)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MOE = reduced(get_model_config("deepseek-moe-16b"))
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
B, S, NEW = 8, 32, 9            # serving: NEW - 1 = 8 decode steps after the prefill
SHAPE = ShapeConfig("t", "train", 64, 4)
STEPS = 3
# training variants: (key in the reference's output, mode, prefetch, remat)
VARIANTS = [(m, m, False, "full") for m in MODES] + [("pd_mcast", "mcast", True, "dots")]
# moe_apply's cases: MoEConfig overrides, no_drop
CASES = {
    "drop": (dict(), False),                       # capacity_factor 1.25: tokens dropped
    "no_drop": (dict(), True),
    "groups": (dict(routing_groups=2, routing_group_topk=1), False),
    # two experts kept a token, three chosen: the third is a tie among zeros
    "ties": (dict(routing_groups=4, routing_group_topk=1, top_k=3), False),
}
T_B, T_S = 8, 2                 # moe_apply's tokens: T = 16, capacity 5 at top-2


def _moe_tree(seed: int) -> dict:
    """A reduced MoE parameter tree with random norm scales."""
    tree = bridge.random_params(MOE, seed)
    rng = np.random.default_rng(seed + 1)
    for holder, name in ((tree, "final_ln"), (tree["blocks"], "ln1"),
                         (tree["blocks"], "ln2")):
        holder[name] = (0.1 * rng.standard_normal(holder[name].shape)).astype(np.float32)
    return tree


def _with(cfg, **moe_kw):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))


# ------------------------------------------------------------- moe_apply


def _layer0() -> dict:
    return {k: (v[0] if not isinstance(v, dict) else {n: a[0] for n, a in v.items()})
            for k, v in bridge.random_params(MOE, 5)["blocks"]["moe"].items()}


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T_B, T_S, MOE.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)   # the output's cotangent
    return x, ct


def _reference(case: str):
    kw, no_drop = CASES[case]
    cfg = _with(ref_reduced(ref_model_config("deepseek-moe-16b")), **kw)
    p = jax.tree.map(jnp.asarray, _layer0())
    x, ct = _inputs()

    def f(p, x):
        out, m = ref_moe.moe_apply(p, x, cfg, no_drop=no_drop)
        return out, m

    (out, metrics), vjp = jax.vjp(f, p, jnp.asarray(x))
    zero = {k: jnp.zeros_like(v) for k, v in metrics.items()}
    one = dict(zero, moe_aux=jnp.ones(()), moe_zloss=jnp.ones(()))
    gp, gx = vjp((jnp.asarray(ct), one))
    return (np.asarray(out), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, gp), np.asarray(gx))


def _port(case: str, r: int):
    """moe_apply over r ranks, each rank (B/r rows) with the layer's weights
    as its gathered copy; the output's cotangent and the aux losses' unit
    cotangents through autograd."""
    kw, no_drop = CASES[case]
    cfg = _with(MOE, **kw)
    leaves = {k: (torch.from_numpy(v).requires_grad_() if not isinstance(v, dict) else
                  {n: torch.from_numpy(a).requires_grad_() for n, a in v.items()})
              for k, v in _layer0().items()}
    p = {k: (v.expand(r, *v.shape) if not isinstance(v, dict) else
             {n: a.expand(r, *a.shape) for n, a in v.items()}) for k, v in leaves.items()}
    x, ct = _inputs()
    xt = torch.from_numpy(x).requires_grad_()
    with use_ctx(ShardCtx(mesh=None)):
        out, metrics = moe.moe_apply(p, xt.reshape(r, T_B // r, T_S, -1), cfg,
                                     no_drop=no_drop)
    out = out.reshape(x.shape)
    loss = (out * torch.from_numpy(ct)).sum() + metrics["moe_aux"] + metrics["moe_zloss"]
    flat = flatten(leaves)
    grads = torch.autograd.grad(loss, [xt, *flat.values()])
    return (out.detach().numpy(), {k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(flat, (g.numpy() for g in grads[1:]))), grads[0].numpy())


@pytest.fixture(scope="module")
def references():
    return {case: _reference(case) for case in CASES}


def _assert_moe_close(got, want, case):
    out, metrics, gp, gx = got
    r_out, r_metrics, r_gp, r_gx = want
    np.testing.assert_allclose(out, r_out, atol=1e-5, rtol=0)
    assert metrics["moe_drop_frac"] == r_metrics["moe_drop_frac"]
    for k in ("moe_aux", "moe_zloss"):
        assert abs(metrics[k] - r_metrics[k]) <= 1e-6, (case, k, metrics[k], r_metrics[k])
    np.testing.assert_allclose(gx, r_gx, atol=1e-5, rtol=0)
    for key, g in gp.items():
        np.testing.assert_allclose(g, flatten(r_gp)[key], atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(references, case):
    """Output, aux metrics and gradients (of the output and of both aux
    losses, for x and every weight) equal the reference's on one rank; at
    capacity factor 1.25 tokens are dropped."""
    got = _port(case, 1)
    _assert_moe_close(got, references[case], case)
    if case == "drop":
        assert got[1]["moe_drop_frac"] > 0
    if case == "no_drop":
        assert got[1]["moe_drop_frac"] == 0


@pytest.mark.parametrize("r", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["drop", "ties"])
def test_routing_is_global_over_ranks(references, case, r):
    """The tokens split over r ranks give the reference's global result: the
    capacity, the positions and the aux metrics come from all T tokens."""
    _assert_moe_close(_port(case, r), references[case], case)


def test_per_rank_routing_would_drop_other_tokens(references):
    """The drop case discriminates: routing each of 8 ranks' 2 tokens alone
    (capacity 1 each) drops another fraction than the global routing."""
    cfg = MOE
    p = {k: (torch.from_numpy(v)[None] if not isinstance(v, dict) else
             {n: torch.from_numpy(a)[None] for n, a in v.items()}) for k, v in _layer0().items()}
    x = torch.from_numpy(_inputs()[0]).reshape(8, 1, T_S, -1)
    drops = []
    with use_ctx(ShardCtx(mesh=None)):
        for r in range(8):
            drops.append(float(moe.moe_apply(p, x[r:r + 1], cfg)[1]["moe_drop_frac"]))
    assert np.mean(drops) != references["drop"][1]["moe_drop_frac"]


def test_expert_owners_split_evenly():
    assert moe.expert_owners(64, 8, "cpu").tolist() == [r for r in range(8) for _ in range(8)]
    assert moe.expert_owners(8, 3, "cpu").tolist() == [0, 0, 0, 1, 1, 1, 2, 2]
    assert moe.expert_owners(2, 4, "cpu").tolist() == [0, 1]
    assert torch.bincount(moe.expert_owners(64, 32, "cpu")).tolist() == [2] * 32


def test_each_expert_reads_only_its_owners_copy():
    """Rank r's experts are computed from its own copy: poison every other
    rank's blocks and the output does not change; the weights' cotangent
    is zero outside the owners' blocks."""
    r = 4
    x = torch.from_numpy(_inputs()[0]).reshape(r, T_B // r, T_S, -1)
    p = {k: (torch.from_numpy(v).expand(r, *v.shape).clone() if not isinstance(v, dict) else
             {n: torch.from_numpy(a).expand(r, *a.shape) for n, a in v.items()})
         for k, v in _layer0().items()}
    with use_ctx(ShardCtx(mesh=None)):
        want, _ = moe.moe_apply(p, x, MOE)
        owners = moe.expert_owners(MOE.moe.n_routed_experts, r, "cpu")
        mask = torch.ones(r, MOE.moe.n_routed_experts, dtype=torch.bool)
        mask[owners, torch.arange(len(owners))] = False
        for name in ("w_gate", "w_up", "w_down"):
            p[name][mask] = float("nan")
            p[name].requires_grad_()
        got, _ = moe.moe_apply(p, x, MOE)
        grads = torch.autograd.grad(got.sum(), [p[n] for n in ("w_gate", "w_up", "w_down")])
    assert torch.equal(got, want)
    for g in grads:
        assert torch.all(g[mask] == 0) and g[~mask].abs().sum() > 0


def test_forward_twice_is_bitwise_equal():
    """No atomics in the dispatch and combine: two runs give the same bits,
    and so do their gradients."""
    runs = [_port("drop", 4) for _ in range(2)]
    a, b = runs
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[3], b[3])
    for key in a[2]:
        assert np.array_equal(a[2][key], b[2][key]), key


def test_moe_specs_match_reference():
    """The MoE rules apply inside ``moe`` but not inside ``shared``; the
    router is split over dp, as the reference's."""
    from types import SimpleNamespace

    from repro.configs import MeshConfig as RefMeshConfig
    from repro.sharding import specs as ref_specs
    tree = _moe_tree(0)
    for axes, multi_pod in (({"data": 8, "model": 1}, False), ({"data": 2, "model": 4}, False),
                            ({"pod": 2, "data": 4, "model": 1}, True)):
        got = specs.param_pspecs(tree, StackedMesh(**axes), MeshConfig(multi_pod=multi_pod))
        want = ref_specs.param_pspecs(tree, SimpleNamespace(shape=dict(axes)),
                                      RefMeshConfig(multi_pod=multi_pod))
        norm = lambda s: tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in s)
        for key, spec in flatten(got).items():
            assert norm(spec) == norm(tuple(flatten(want)[key])), (axes, key)
    assert specs.is_sharded(flatten(got)["blocks/moe/router"], ("pod", "data"))


def test_device_params_layout_matches_to_torch():
    """``device_params`` gives the leaves, specs, shapes and dtypes of
    ``to_torch(random_params(...))``, in the init scales."""
    mesh = StackedMesh(data=8, model=1)
    want = flatten(bridge.to_torch(bridge.random_params(MOE, 0), mesh, MeshConfig(),
                                   dtype=torch.bfloat16, device="cpu"))
    got = flatten(bridge.device_params(MOE, mesh, MeshConfig(), seed=0, dtype=torch.bfloat16,
                                       device="cpu"))
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        w = want[key]
        assert (leaf.spec, leaf.local.shape, leaf.local.dtype) == \
            (w.spec, w.local.shape, w.local.dtype), key
        std = leaf.local.float().std().item()
        assert std == pytest.approx(w.local.float().std().item(), rel=0.1, abs=1e-6), key


# --------------------------------------------------- serving, training, ckpt

_BODY = f'''
import dataclasses
import os
import jax.numpy as jnp
from repro.checkpoint import restore, save
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced, replace)
from repro.data import SyntheticPipeline
from repro.optim import adamw
from repro.runtime import init_state
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
from repro.runtime.train_loop import TrainState, jit_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        OUT[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32) if leaf.dtype == jnp.bfloat16
                                       else leaf)

class SmallMesh(MeshConfig):
    @property
    def shape(self): return (2, 4)
    @property
    def axes(self): return ("data", "model")

cfg = reduced(get_model_config("deepseek-moe-16b"))

# serving on (8, 1)
mesh = ref_mesh((8, 1), ("data", "model"))
params = jax.tree.map(jnp.asarray, unflatten(IN, "serve/"))
tokens = IN["tokens"]
for mode in {MODES}:
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    _, step = jit_prefill_step(run, mesh)
    logits, cache = step(params, {{"tokens": tokens}})
    OUT[mode + "/logits"] = np.asarray(logits)
    OUT[mode + "/k"], OUT[mode + "/v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + NEW}, {B}))
_, dec = jit_decode_step(run, mesh)
cache = {{n: np.pad(OUT["xla/" + n], [(0, 0)] * 3 + [(0, {NEW}), (0, 0)]) for n in "kv"}}
state = ServeState(cache, np.full(({B},), {S}, np.int32))
tok = np.argmax(OUT["xla/logits"], -1).astype(np.int32)
toks, lgs = [tok], []
for _ in range({NEW - 1}):
    lg, state = dec(params, state, tok)
    tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
    lgs.append(np.asarray(lg))
    toks.append(tok)
OUT["decode/logits"], OUT["decode/tokens"] = np.stack(lgs), np.stack(toks, 1)

# training on (2, 4)
mesh = ref_mesh((2, 4), ("data", "model"))
shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
pipe = SyntheticPipeline(cfg, shape)
for key, mode, prefetch, remat in {VARIANTS}:
    run = RunConfig(model=cfg, shape=shape, mesh=SmallMesh(),
                    train=TrainConfig(steps=5, remat=remat),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2, prefetch=prefetch))
    _, jstep = jit_train_step(run, mesh)
    params = jax.tree.map(jnp.asarray, unflatten(IN, "train/"))
    state = TrainState(params, adamw.init(params))
    for i in range({STEPS}):
        state, m = jstep(state, pipe.next_batch(i))
        for name in ("loss", "grad_norm", "moe_aux", "moe_zloss", "moe_drop_frac"):
            OUT[f"{{key}}/{{name}}{{i}}"] = np.asarray(m[name])
    put(key + "/params/", state.params)

# checkpoints: the reference's bf16 MoE state saved; the port's restored
bf16 = replace(cfg, param_dtype="bfloat16")
state = init_state(RunConfig(model=bf16, shape=ShapeConfig("t", "train", 32, 8)), None,
                   jax.random.PRNGKey(0))
save(state, str(IN["ref_dir"]), 5)
put("ref_state/", state)
like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
restored, manifest = restore(str(IN["port_dir"]), 3, like)
put("port_restored/", restored)
'''


def _f32(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.view(np.uint16).astype(np.uint32).__lshift__(16).view(np.float32) \
        if dtype == "bfloat16" else a


def _train(tree, mode: str, mesh, prefetch: bool = False, remat: str = "full"):
    run = RunConfig(model=MOE, shape=SHAPE, train=TrainConfig(steps=5, remat=remat),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2, prefetch=prefetch))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    pipe = SyntheticPipeline(MOE, SHAPE, device="cpu")
    metrics = []
    for i in range(STEPS):
        state, m = step(state, pipe.next_batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The reference's serving, training and checkpoints in one subprocess;
    the port's bf16 MoE state on ``(data=2, model=4)`` saved before it."""
    tmp = tmp_path_factory.mktemp("moe_ckpt")
    dirs = {name: str(tmp / name) for name in ("port_dir", "ref_dir")}
    bf16 = replace(MOE, param_dtype="bfloat16")
    port_state = init_state(RunConfig(model=bf16, shape=ShapeConfig("t", "train", 32, 8)),
                            StackedMesh(data=2, model=4), _moe_tree(3), device="cpu")
    save(port_state, dirs["port_dir"], 3)
    serve_tree, train_tree = _moe_tree(0), _moe_tree(4)
    tokens = np.random.default_rng(7).integers(0, MOE.vocab_size, (B, S)).astype(np.int32)
    inputs = {"serve/" + k: v for k, v in flatten(serve_tree).items()}
    inputs.update({"train/" + k: v for k, v in flatten(train_tree).items()})
    inputs.update(tokens=tokens, **{k: np.asarray(v) for k, v in dirs.items()})
    ref = run_reference(_BODY, inputs)
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(serve_tree, mesh, MeshConfig(), dtype=torch.float32,
                             device="cpu")
    return dict(ref=ref, mesh=mesh, params=params, tokens=torch.from_numpy(tokens).long(),
                train_tree=train_tree, dirs=dirs, port_state=port_state)


def _prefill(case, mode):
    _, _, prefill = make_prefill_step(serve_run(MOE, mode, B, S), case["mesh"], device="cpu")
    return prefill(case["params"], {"tokens": case["tokens"]})


@pytest.mark.parametrize("mode", MODES)
def test_prefill_matches_jax(case, mode):
    ref = case["ref"]
    logits, cache = _prefill(case, mode)
    assert logits.shape == (B, MOE.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref[mode + "/logits"], atol=1e-5, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), ref[mode + "/" + n], atol=1e-5, rtol=0)


def test_decode_and_greedy_match_jax(case):
    """8 decode steps from the prefill's cache (no drops at decode): the
    reference's tokens, logits within 1e-4; then greedy generation in every
    mode, the same tokens. (The reference's own ``greedy_generate`` feeds
    the prompt through decode, where nothing is dropped, so at this
    capacity its tokens are not its prefill step's.)"""
    ref, mesh, params, tokens = case["ref"], case["mesh"], case["params"], case["tokens"]
    logits, cache = _prefill(case, "xla")
    _, _, decode = make_decode_step(serve_run(MOE, "mcast", B, S + NEW, "decode"), mesh,
                                    device="cpu")
    state = ServeState({n: F.pad(c, (0, 0, 0, NEW)) for n, c in cache.items()},
                       torch.full((B,), S, dtype=torch.long))
    tok = logits.argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["decode/tokens"])
    np.testing.assert_allclose(torch.stack(lgs).numpy(), ref["decode/logits"], atol=1e-4,
                               rtol=0)
    for mode in MODES:
        run = serve_run(MOE, mode, B, S)
        _, _, prefill = make_prefill_step(run, mesh, device="cpu")
        _, _, dec = make_decode_step(run, mesh, device="cpu")
        out = greedy_generate(prefill, dec, params, tokens, NEW, S + NEW)
        assert torch.equal(out[:, :S], tokens)
        np.testing.assert_array_equal(out[:, S:].numpy(), ref["decode/tokens"], err_msg=mode)


@pytest.fixture(scope="module")
def trained(case):
    # the reference's (2, 4) runs EP over ``model``; the port's 2 dp ranks at
    # tp = 1 carry the same values (its EP over ``model``:
    # tests/test_torch_ep.py)
    mesh = StackedMesh(data=2, model=1)
    return mesh, {key: _train(case["train_tree"], mode, mesh, prefetch, remat)
                  for key, mode, prefetch, remat in VARIANTS}


@pytest.mark.parametrize("key", [v[0] for v in VARIANTS])
def test_train_steps_match_jax(case, trained, key):
    """3 steps: loss and the moe_* metrics within 1e-5, grad_norm within
    1e-4 relative, then every parameter within 1e-5."""
    ref = case["ref"]
    mesh, runs = trained
    state, metrics = runs[key]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{key}/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{key}/grad_norm{i}"]), rel=1e-4), i
        for name in ("moe_aux", "moe_zloss", "moe_drop_frac"):
            assert abs(m[name] - float(ref[f"{key}/{name}{i}"])) <= 1e-5, (i, name)
    params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                     MeshConfig()))
    for name, a in params.items():
        np.testing.assert_allclose(a, ref[f"{key}/params/{name}"], atol=1e-5, rtol=0,
                                   err_msg=name)


def test_train_modes_agree_bitwise_on_the_first_loss(trained):
    runs = trained[1]
    first = {key: runs[key][1][0]["loss"] for key in runs}
    assert len(set(first.values())) == 1, first


def test_reference_moe_checkpoint_restores_in_port(case):
    """The reference's bf16 MoE state, saved with no mesh, restored into the
    port's ``(data=2, model=4)`` structure: every array bitwise, the same
    keys and dtypes as the port's own checkpoint of it."""
    ref, dirs = case["ref"], case["dirs"]
    restored, manifest = restore(dirs["ref_dir"], 5, case["port_state"], mesh=None)
    got = host_arrays(restored)
    assert list(got) == manifest["keys"]
    assert got["params/blocks/moe/router"][1] == "float32"
    for key, (a, dtype) in got.items():
        np.testing.assert_array_equal(_f32(a, dtype), ref["ref_state/" + key], err_msg=key)


def test_port_moe_checkpoint_restores_in_reference(case):
    ref = case["ref"]
    for key, (a, dtype) in host_arrays(case["port_state"]).items():
        np.testing.assert_array_equal(ref["port_restored/" + key], _f32(a, dtype), err_msg=key)

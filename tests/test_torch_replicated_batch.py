"""A global batch that does not split over the dp ranks, against the JAX
package: every rank gets the whole batch, as the reference's GSPMD
replicates it (``ShardCtx.shard_batch`` False).

The reference runs ``jit_train_step``, ``jit_prefill_step`` and
``jit_decode_step`` in a subprocess with 8 fake CPU devices on Auto meshes,
from the same bridged parameters and synthetic batches (the
``grad_accum=2`` case in ``tests/test_torch_replicated_accum.py``'s). Training: 3 steps in
every fsdp_mode at global batch 6 on ``(pod=2, data=2, model=2)``, at batch
4 on ``(data=8, model=1)``, and there with ``grad_accum=2``; loss within
1e-5 and grad_norm within 1e-4 relative, parameters within 1e-5 and each
moment leaf within 1e-5 of its largest value (``tests/test_torch_train.py``'s
limits). Serving: prefill and 8 decode steps at batch 4 on ``(data=8,
model=1)``; prefill logits and KV cache within 1e-5, decode logits within
1e-4, the same tokens (``tests/test_torch_serve.py``'s limits).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.checkpoint.ckpt import host_arrays
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.ctx import use_ctx
from repro_torch.models import transformer
from test_torch_support import (SMALL, flatten, one_torch_thread, random_tree,  # noqa: F401
                                run_reference, serve_run)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
STEPS = 3
SEQ = 32
# key: (mesh axes, multi_pod, global batch, grad_accum)
CASES = {
    "pod": ({"pod": 2, "data": 2, "model": 2}, True, 6, 1),
    "dp8": ({"data": 8, "model": 1}, False, 4, 1),
    "dp8_accum": ({"data": 8, "model": 1}, False, 4, 2),
}
B, S, NEW = 4, 32, 9   # serving: NEW - 1 = 8 decode steps after the prefill


def reference_body(keys: tuple[str, ...], serve: bool) -> str:
    """The reference's 3 steps of ``CASES[key]`` for each key, and with
    ``serve`` its prefill and decode at batch ``B``."""
    cases = {k: (tuple(CASES[k][0].values()), tuple(CASES[k][0]), *CASES[k][1:])
             for k in keys}
    body = f'''
import jax.numpy as jnp
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced)
from repro.data import SyntheticPipeline
from repro.optim import adamw
from repro.runtime.train_loop import TrainState, jit_train_step

def mesh_config(shape_, axes_, multi_pod):
    class Cfg(MeshConfig):
        @property
        def shape(self): return shape_
        @property
        def axes(self): return axes_
    return Cfg(multi_pod=multi_pod)

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        OUT[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

cfg = reduced(get_model_config("smollm-135m"))
for key, (shape_, axes_, multi_pod, batch, accum) in {cases}.items():
    mesh = ref_mesh(shape_, axes_)
    shape = ShapeConfig("t", "train", {SEQ}, batch)
    pipe = SyntheticPipeline(cfg, shape)
    for mode in {MODES}:
        run = RunConfig(model=cfg, shape=shape, mesh=mesh_config(shape_, axes_, multi_pod),
                        train=TrainConfig(steps=5, grad_accum=accum),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, jstep = jit_train_step(run, mesh)
        params = jax.tree.map(jnp.asarray, unflatten(IN, "params/"))
        state = TrainState(params, adamw.init(params))
        at = f"{{key}}/{{mode}}"
        for i in range({STEPS}):
            state, m = jstep(state, pipe.next_batch(i))
            OUT[f"{{at}}/loss{{i}}"] = np.asarray(m["loss"])
            OUT[f"{{at}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        put(at + "/params/", state.params)
        put(at + "/opt/m/", state.opt.m)
        put(at + "/opt/v/", state.opt.v)
'''
    return body + SERVE_BODY if serve else body


SERVE_BODY = f'''
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
mesh = ref_mesh((8, 1), ("data", "model"))
params = unflatten(IN, "params/")
tokens = IN["tokens"]
for mode in {MODES}:
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    _, step = jit_prefill_step(run, mesh)
    logits, cache = step(params, {{"tokens": tokens}})
    OUT["serve/" + mode + "/logits"] = np.asarray(logits)
    OUT["serve/" + mode + "/k"] = np.asarray(cache["k"])
    OUT["serve/" + mode + "/v"] = np.asarray(cache["v"])
run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + NEW}, {B}))
_, dec = jit_decode_step(run, mesh)
cache = {{n: np.pad(OUT["serve/xla/" + n], [(0, 0)] * 3 + [(0, {NEW}), (0, 0)]) for n in "kv"}}
state = ServeState(cache, np.full(({B},), {S}, np.int32))
tok = np.argmax(OUT["serve/xla/logits"], -1).astype(np.int32)
toks, lgs = [tok], []
for _ in range({NEW - 1}):
    lg, state = dec(params, state, tok)
    tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
    lgs.append(np.asarray(lg))
    toks.append(tok)
OUT["decode/logits"], OUT["decode/tokens"] = np.stack(lgs), np.stack(toks, 1)
'''


def make_case(keys: tuple[str, ...], serve: bool):
    """(tree, prompt tokens, the reference's outputs)."""
    tree = random_tree(SMALL, 5)
    tokens = np.random.default_rng(8).integers(0, SMALL.vocab_size, (B, S)).astype(np.int32)
    inputs = {"params/" + k: v for k, v in flatten(tree).items()}
    inputs["tokens"] = tokens
    return tree, torch.from_numpy(tokens).long(), run_reference(reference_body(keys, serve),
                                                                inputs)


@pytest.fixture(scope="module")
def case():
    return make_case(("pod", "dp8"), serve=True)


def _train_run(key: str, mode: str) -> tuple[RunConfig, StackedMesh]:
    axes, multi_pod, batch, accum = CASES[key]
    run = RunConfig(model=SMALL, shape=ShapeConfig("t", "train", SEQ, batch),
                    mesh=MeshConfig(multi_pod=multi_pod),
                    train=TrainConfig(steps=5, grad_accum=accum),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    return run, StackedMesh(**axes)


def _train(tree, run: RunConfig, mesh: StackedMesh | None, steps: int = STEPS):
    _, ctx, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    pipe = SyntheticPipeline(SMALL, run.shape, device="cpu")
    metrics = []
    for i in range(steps):
        state, m = step(state, pipe.next_batch(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return ctx, state, metrics


def assert_train_matches_jax(case, key: str, mode: str) -> None:
    """Losses and grad norms of 3 steps, then every parameter and moment."""
    tree, _, ref = case
    run, mesh = _train_run(key, mode)
    ctx, state, metrics = _train(tree, run, mesh)
    assert not ctx.shard_batch
    at = f"{key}/{mode}"
    for i, (loss, gn) in enumerate(metrics):
        assert loss == pytest.approx(float(ref[f"{at}/loss{i}"]), rel=1e-5), i
        assert gn == pytest.approx(float(ref[f"{at}/grad_norm{i}"]), rel=1e-4), i
    got = host_arrays(state)
    assert got["opt/step"][0] == STEPS
    for name, (a, _) in got.items():
        if name == "opt/step":
            continue
        want = ref[f"{at}/{name}"]
        atol = 1e-5 if name.startswith("params/") else 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(a, want, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key", ["pod", "dp8"])
def test_replicated_train_matches_jax(case, key, mode):
    assert_train_matches_jax(case, key, mode)


def test_replicated_modes_agree_on_the_first_step(case):
    """The gathers are exact copies: every mode's first-step loss is the
    same bits, at each replicated batch."""
    tree = case[0]
    for key in CASES:
        first = {mode: _train(tree, *_train_run(key, mode), steps=1)[2][0][0] for mode in MODES}
        assert len(set(first.values())) == 1, (key, first)


def test_replicated_step_matches_one_rank(case):
    """The replicated step is the single-rank step: the mean over the R
    copies of the loss, and their gradients summed into the shards, so the
    gradient is not R times too large."""
    tree = case[0]
    run, mesh = _train_run("dp8", "mcast")
    _, _, sharded = _train(tree, run, mesh)
    _, _, one = _train(tree, run, None)
    for (loss, gn), (l1, g1) in zip(sharded, one):
        assert loss == pytest.approx(l1, rel=1e-5) and gn == pytest.approx(g1, rel=1e-4)


def test_batch_that_splits_still_shards():
    """A batch that divides over dp keeps the rank-major split; a context
    that shards raises on one that does not."""
    mesh = StackedMesh(data=8, model=1)
    from repro_torch.runtime.train_loop import make_ctx
    with use_ctx(make_ctx(serve_run(SMALL, "mcast", 8, 16), mesh)) as ctx:
        assert ctx.shard_batch
        t = torch.arange(16).reshape(8, 2)
        assert torch.equal(transformer.to_ranks(t, 8)[3], t[3:4])
        assert torch.equal(transformer.from_ranks(transformer.to_ranks(t, 8)), t)
        with pytest.raises(ValueError, match="does not split"):
            transformer.to_ranks(torch.zeros(4, 2), 8)
    with use_ctx(make_ctx(serve_run(SMALL, "mcast", 4, 16), mesh)) as ctx:
        assert not ctx.shard_batch
        t = torch.arange(8).reshape(4, 2)
        ranks = transformer.to_ranks(t, 8)
        assert ranks.shape == (8, 4, 2) and ranks.stride(0) == 0
        assert torch.equal(transformer.from_ranks(ranks), t)


# ------------------------------------------------------------------ serving


def _serving(case, mode: str):
    tree, tokens, _ = case
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    _, ctx, prefill = make_prefill_step(serve_run(SMALL, mode, B, S), mesh, device="cpu")
    _, _, decode = make_decode_step(serve_run(SMALL, mode, B, S + NEW, "decode"), mesh,
                                    device="cpu")
    assert not ctx.shard_batch
    return params, prefill, decode, tokens


@pytest.mark.parametrize("mode", MODES)
def test_replicated_prefill_matches_jax(case, mode):
    """(B, V) logits once, and a (L, B, ...) KV cache: rank 0's rows."""
    ref = case[2]
    params, prefill, _, tokens = _serving(case, mode)
    logits, cache = prefill(params, {"tokens": tokens})
    assert logits.shape == (B, SMALL.vocab_size)
    assert cache["k"].shape == ref[f"serve/{mode}/k"].shape
    np.testing.assert_allclose(logits.numpy(), ref[f"serve/{mode}/logits"], atol=1e-5, rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), ref[f"serve/{mode}/{n}"], atol=1e-5,
                                   rtol=0)


def test_replicated_decode_matches_jax(case):
    """8 decode steps from the prefill's cache, the R ranks sharing it: the
    reference's tokens, logits within 1e-4; greedy_generate keeps (B, S +
    new) and gives the same tokens."""
    ref = case[2]
    params, prefill, decode, tokens = _serving(case, "mcast")
    logits, cache = prefill(params, {"tokens": tokens})
    state = ServeState({n: F.pad(c, (0, 0, 0, NEW)) for n, c in cache.items()},
                       torch.full((B,), S, dtype=torch.long))
    tok = logits.argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    assert state.cache["k"].shape[1] == B
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["decode/tokens"])
    np.testing.assert_allclose(torch.stack(lgs).numpy(), ref["decode/logits"], atol=1e-4,
                               rtol=0)
    out = greedy_generate(prefill, decode, params, tokens, NEW, S + NEW)
    assert out.shape == (B, S + NEW)
    np.testing.assert_array_equal(out[:, S:].numpy(), ref["decode/tokens"])


def test_replicated_serving_modes_agree_bitwise(case):
    outs = {}
    for mode in MODES:
        params, prefill, decode, tokens = _serving(case, mode)
        logits, _ = prefill(params, {"tokens": tokens})
        outs[mode] = (logits, greedy_generate(prefill, decode, params, tokens, 4, S + 4))
    for mode in MODES[1:]:
        assert torch.equal(outs[mode][0], outs["xla"][0]), mode
        assert torch.equal(outs[mode][1], outs["xla"][1]), mode

"""The training path's two options against the JAX package's:
``CollectiveConfig.prefetch`` (the gather of layer i + 1 issued during
layer i, ``_scan_blocks_prefetch``) and ``TrainConfig(remat="dots")`` (keep
every product's output, ``checkpoint_dots``), alone and together.

The reference runs ``jit_train_step`` in one subprocess for the whole file,
with 8 fake CPU devices on an Auto ``(data=2, model=4)`` mesh, in every
fsdp_mode and each variant, from the same bridged parameters and batches as
``tests/test_torch_train.py``. Tolerances are that file's: loss within 1e-5
and grad_norm within 1e-4 relative over 3 steps, parameters within 1e-5 and
each moment leaf within 1e-5 of its largest value. Within the port the
options change no value: losses and gradients are bitwise those of the
step without them, on the CPU's plain kernels.
"""
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, reduced)
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels import collective_matmul as M
from repro_torch.launch.mesh import StackedMesh
from repro_torch.runtime.serve_loop import make_prefill_step
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.ctx import use_ctx
from repro_torch.sharding.fsdp import at_use
from repro_torch.sharding.specs import tree_leaves
from test_torch_support import SMALL, flatten, random_tree, run_reference
from test_torch_train import (MODES, _run, _train, assert_matches_reference,
                              reference_body)

# (key in the reference's output, prefetch, remat)
VARIANTS = [("prefetch_full/", True, "full"), ("dots/", False, "dots"),
            ("prefetch_dots/", True, "dots")]
LEAVES = 7   # gathered weights of a dense layer: wq wk wv wo w_gate w_up w_down


@pytest.fixture(scope="module")
def case():
    tree = random_tree(SMALL, 4)
    ref = run_reference(reference_body(VARIANTS),
                        {"params/" + k: v for k, v in flatten(tree).items()})
    return tree, StackedMesh(data=2, model=4), ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key,prefetch,remat", VARIANTS, ids=[v[0][:-1] for v in VARIANTS])
def test_train_options_match_jax(case, key, prefetch, remat, mode):
    """Loss and grad_norm of 3 steps, then parameters and both moments,
    against the reference's step with the same option."""
    tree, mesh, ref = case
    state, metrics = _train(tree, mode, mesh, prefetch=prefetch, remat=remat)
    assert_matches_reference(ref, key + mode, state, metrics, mesh)


def _loss_and_grads(tree, run: RunConfig, mesh: StackedMesh):
    api, ctx, _ = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    batch = SyntheticPipeline(run.model, run.shape, device="cpu").next_batch(0)
    with use_ctx(ctx):
        loss, _ = api.loss_fn(at_use(state.params, mesh.n_ranks, ("data",)), batch)
        leaves = [s.local for s in tree_leaves(state.params)]
        return ctx, loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("prefetch,remat", [(False, "dots"), (True, "none"), (True, "full"),
                                            (True, "dots")])
def test_options_change_no_value(prefetch, remat):
    """Each option, on three layers (a body step between the first gather
    and the last block), gives the loss and every gradient of the step
    without options, bitwise."""
    cfg = reduced(SMALL, layers=3)
    tree = random_tree(cfg, 2)
    mesh = StackedMesh(data=2, model=1)
    base = _run("mcast").replace(model=cfg)
    _, want_loss, want = _loss_and_grads(tree, base, mesh)
    run = base.replace(train=TrainConfig(steps=5, remat=remat),
                       collective=CollectiveConfig(fsdp_mode="mcast", n_chains=2,
                                                   prefetch=prefetch))
    ctx, loss, got = _loss_and_grads(tree, run, mesh)
    assert ctx.prefetch_params == prefetch
    assert torch.equal(loss, want_loss)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _counting(monkeypatch) -> dict[str, int]:
    """Counts of the calls that are launches on the card (the gather, its
    transpose, the matmul), made here on the CPU's plain versions."""
    counts = {"gather": 0, "transpose": 0, "matmul": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(C, "ring_allgather", counted("gather", C.ring_allgather))
    monkeypatch.setattr(C, "ring_allgather_transpose",
                        counted("transpose", C.ring_allgather_transpose))
    monkeypatch.setattr(M, "matmul", counted("matmul", M.matmul))
    return counts


@pytest.mark.parametrize("prefetch,remat", [(False, "full"), (True, "full"), (False, "dots"),
                                            (True, "dots"), (True, "none")])
def test_launches_per_step(monkeypatch, prefetch, remat):
    """What each option runs in a train step of L = 3 layers, as on the card:
    a gather per leaf and layer in the forward, again in the backward for
    each checkpointed body (with prefetch, L - 1 bodies, each gathering the
    next layer: layer 0 and the last block are outside them); a transpose
    per gather of the forward; the matmuls three per projection (forward,
    dx, dw) and the head's four (forward, its checkpoint's recompute, dx,
    dw), plus a projection's forward again in each body that "full"
    recomputes ("dots" keeps them)."""
    cfg = reduced(SMALL, layers=3)
    run = _run("mcast", prefetch=prefetch, remat=remat).replace(model=cfg)
    mesh = StackedMesh(data=2, model=1)
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, random_tree(cfg, 3), device="cpu")
    batch = SyntheticPipeline(cfg, run.shape, device="cpu").next_batch(0)
    counts = _counting(monkeypatch)
    step(state, batch)
    layers = cfg.num_layers
    bodies = 0 if remat == "none" else layers - 1 if prefetch else layers
    assert counts == {"gather": LEAVES * (layers + bodies),
                      "transpose": LEAVES * layers,
                      "matmul": 3 * LEAVES * layers + 4
                      + (LEAVES * bodies if remat == "full" else 0)}


@pytest.mark.parametrize("case_", ["xla", "one_layer"])
def test_prefetch_is_inert_where_the_reference_ignores_it(monkeypatch, case_):
    """In ``xla`` mode (the reference installs no gather of its own) and on a
    one-layer model the step with prefetch is the step without it: the
    context says so, and the loss, the gradients and the launches match."""
    mode, cfg = ("xla", SMALL) if case_ == "xla" else ("mcast", reduced(SMALL, layers=1))
    tree = random_tree(cfg, 5)
    mesh = StackedMesh(data=2, model=1)
    out = {}
    for prefetch in (False, True):
        run = _run(mode, prefetch=prefetch).replace(model=cfg)
        counts = _counting(monkeypatch)
        ctx, loss, grads = _loss_and_grads(tree, run, mesh)
        out[prefetch] = (loss, grads, dict(counts))
        assert ctx.prefetch_params == (prefetch and mode != "xla")
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    assert out[True][2] == out[False][2]


def test_prefill_with_prefetch_computes_the_same_cache():
    """Prefill (a kv cache) never prefetches, as in the reference: with the
    option set its logits and cache are bitwise those without it."""
    mesh = StackedMesh(data=2, model=1)
    tree = random_tree(SMALL, 6)
    tokens = SyntheticPipeline(SMALL, ShapeConfig("t", "train", 16, 4),
                               device="cpu").next_batch(0)["tokens"]
    out = {}
    for prefetch in (False, True):
        run = _run("mcast_bcast", prefetch=prefetch).replace(
            shape=ShapeConfig("t", "prefill", 16, 4))
        _, ctx, prefill = make_prefill_step(run, mesh, device="cpu")
        params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
        out[prefetch] = prefill(params, {"tokens": tokens})
        assert ctx.prefetch_params == prefetch
    assert torch.equal(out[True][0], out[False][0])
    for name in ("k", "v"):
        assert torch.equal(out[True][1][name], out[False][1][name])

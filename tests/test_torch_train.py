"""The port's training path against the JAX package's: the FSDP train step
of reduced smollm-135m in f32 on the same bridged parameters and the same
synthetic batches, in every fsdp_mode, plus its pieces (data, AdamW, loss,
remat, the trainable layout) and ports of the reference's own training
tests.

The reference runs ``jit_train_step`` in a subprocess with 8 fake CPU
devices on an Auto ``(data=2, model=4)`` mesh; the port stacks the two dp
ranks (``model`` is layout only). Tolerances: loss within 1e-5 and
grad_norm within 1e-4 relative of the reference over 3 steps, parameters
after them within 1e-5 and each moment leaf within 1e-5 of its largest
value (f32 sums in another order; about 1e-6 is seen); the four modes within
1e-6 (loss) and 1e-5 (grad_norm) of each other, the reference's own limits
(tests/test_train_integration.py:83-84).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RefTrainConfig
from repro.optim import adamw as ref_adamw
from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.models.model_builder import chunked_xent
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.ctx import use_ctx
from repro_torch.sharding.fsdp import at_use, trainable
from repro_torch.sharding.specs import Stacked, tree_leaves
from test_torch_support import SMALL, flatten, random_tree, run_reference

MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
SHAPE = ShapeConfig("t", "train", 64, 4)
STEPS = 3


def reference_body(variants=(("", False, "full"),)) -> str:
    """The reference's ``jit_train_step`` for ``STEPS`` steps in every mode
    from the parameters in ``IN``, once per variant ``(key, prefetch,
    remat)``: losses, grad norms, then parameters and both moments, under
    ``{key}{mode}/``; and the batches' tokens."""
    return f'''
import jax.numpy as jnp
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced)
from repro.data import SyntheticPipeline
from repro.optim import adamw
from repro.runtime.train_loop import TrainState, jit_train_step

class SmallMesh(MeshConfig):
    @property
    def shape(self): return (2, 4)
    @property
    def axes(self): return ("data", "model")

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        OUT[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

cfg = reduced(get_model_config("smollm-135m"))
mesh = ref_mesh((2, 4), ("data", "model"))
shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
pipe = SyntheticPipeline(cfg, shape)
for i in range({STEPS}):
    OUT[f"tokens{{i}}"] = np.asarray(pipe.next_batch(i)["tokens"])
for key, prefetch, remat in {list(variants)}:
    for mode in {MODES}:
        run = RunConfig(model=cfg, shape=shape, mesh=SmallMesh(),
                        train=TrainConfig(steps=5, remat=remat),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2,
                                                    prefetch=prefetch))
        _, jstep = jit_train_step(run, mesh)
        params = jax.tree.map(jnp.asarray, unflatten(IN, "params/"))
        state = TrainState(params, adamw.init(params))
        at = key + mode
        for i in range({STEPS}):
            state, m = jstep(state, pipe.next_batch(i))
            OUT[f"{{at}}/loss{{i}}"] = np.asarray(m["loss"])
            OUT[f"{{at}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        put(at + "/params/", state.params)
        put(at + "/m/", state.opt.m)
        put(at + "/v/", state.opt.v)
'''


def _run(mode: str, prefetch: bool = False, **train) -> RunConfig:
    return RunConfig(model=SMALL, shape=SHAPE, train=TrainConfig(steps=5, **train),
                     collective=CollectiveConfig(fsdp_mode=mode, n_chains=2, prefetch=prefetch))


def _train(tree, mode: str, mesh, steps: int = STEPS, **options):
    run = _run(mode, **options)
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    pipe = SyntheticPipeline(SMALL, run.shape, device="cpu")
    metrics = []
    for i in range(steps):
        state, m = step(state, pipe.next_batch(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


@pytest.fixture(scope="module")
def case():
    tree = random_tree(SMALL, 4)
    ref = run_reference(reference_body(), {"params/" + k: v for k, v in flatten(tree).items()})
    mesh = StackedMesh(data=2, model=4)
    port = {mode: _train(tree, mode, mesh) for mode in MODES}
    return tree, mesh, ref, port


def _state_numpy(state, mesh, n_ranks):
    dp = ("data",)
    return {name: flatten(bridge.to_numpy(at_use(tree, n_ranks, dp), mesh, MeshConfig()))
            for name, tree in (("params", state.params), ("m", state.opt.m),
                               ("v", state.opt.v))}


def test_batches_match_reference(case):
    ref = case[2]
    pipe = SyntheticPipeline(SMALL, SHAPE, device="cpu")
    for i in range(STEPS):
        batch = pipe.next_batch(i)
        np.testing.assert_array_equal(batch["tokens"].numpy(), ref[f"tokens{i}"])
        assert batch["tokens"].dtype == torch.long


def assert_matches_reference(ref, at: str, state, metrics, mesh) -> None:
    """Loss and grad_norm of every step within 1e-5 and 1e-4 relative of the
    reference's under ``at``; then parameters within 1e-5 and each moment
    leaf within 1e-5 of its largest value."""
    for i, (loss, gn) in enumerate(metrics):
        assert loss == pytest.approx(float(ref[f"{at}/loss{i}"]), rel=1e-5), i
        assert gn == pytest.approx(float(ref[f"{at}/grad_norm{i}"]), rel=1e-4), i
    got = _state_numpy(state, mesh, mesh.n_ranks)
    for key, a in got["params"].items():
        np.testing.assert_allclose(a, ref[f"{at}/params/{key}"], atol=1e-5, rtol=0,
                                   err_msg=key)
    for name in ("m", "v"):
        for key, a in got[name].items():
            want = ref[f"{at}/{name}/{key}"]
            np.testing.assert_allclose(a, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_jax(case, mode):
    """Loss and grad_norm of 3 steps, then parameters and both moments."""
    _, mesh, ref, port = case
    state, metrics = port[mode]
    assert_matches_reference(ref, mode, state, metrics, mesh)


def test_modes_agree(case):
    """The reference's own limits between modes; the forward of the first
    step is bitwise equal in every mode (the gathers are exact copies)."""
    port = case[3]
    base = port["xla"][1]
    for mode in MODES[1:]:
        assert port[mode][1][0][0] == base[0][0], mode
        for (loss, gn), (bl, bg) in zip(port[mode][1], base):
            assert abs(loss - bl) < 1e-6 and abs(gn - bg) < 1e-5, mode


def test_sharded_step_matches_one_rank(case):
    """The same step with no mesh (one rank, nothing gathered): the global
    token mean and the global norm, each replicated leaf counted once."""
    tree, _, _, port = case
    _, one = _train(tree, "mcast", None)
    for (loss, gn), (l1, g1) in zip(port["mcast"][1], one):
        assert loss == pytest.approx(l1, rel=1e-5) and gn == pytest.approx(g1, rel=1e-4)


def test_trainable_layout():
    """Sharded leaves are (R, *local) leaf tensors; a replicated leaf is one
    tensor, expanded at use, and its gradient is the sum over ranks."""
    mesh = StackedMesh(data=2, model=4)
    params = bridge.to_torch(random_tree(SMALL, 0), mesh, MeshConfig(), dtype=torch.float32,
                             device="cpu")
    train = trainable(params, ("data",))
    wq, ln1 = train["blocks"]["attn"]["wq"], train["blocks"]["ln1"]
    assert wq.local.is_leaf and wq.local.requires_grad and wq.local.shape[0] == 2
    assert ln1.local.is_leaf and ln1.local.shape == (SMALL.num_layers, SMALL.d_model)
    used = at_use(train, 2, ("data",))["blocks"]["ln1"].local
    assert used.shape == (2, SMALL.num_layers, SMALL.d_model) and used.stride(0) == 0
    (g,) = torch.autograd.grad((used * torch.tensor([1.0, 2.0])[:, None, None]).sum(),
                               ln1.local)
    assert torch.equal(g, torch.full_like(g, 3.0))


@pytest.mark.parametrize("axes,multi_pod", [
    ({"data": 8, "model": 1}, False),
    ({"data": 2, "model": 4}, False),
    ({"pod": 2, "data": 4, "model": 1}, True),
])
def test_to_numpy_inverts_to_torch(axes, multi_pod):
    mesh, mesh_cfg = StackedMesh(**axes), MeshConfig(multi_pod=multi_pod)
    tree = random_tree(SMALL, 1)
    back = flatten(bridge.to_numpy(bridge.to_torch(tree, mesh, mesh_cfg, dtype=torch.float32,
                                                   device="cpu"), mesh, mesh_cfg))
    for key, a in flatten(tree).items():
        np.testing.assert_array_equal(back[key], a, err_msg=key)


def test_remat_full_equals_none():
    """Checkpointing re-runs each layer's gather and block in the backward:
    the same loss and gradients bitwise, and the forward ring steps run
    twice."""
    tree = random_tree(SMALL, 2)
    mesh = StackedMesh(data=2, model=1)
    batch = SyntheticPipeline(SMALL, SHAPE, device="cpu").next_batch(0)
    out = {}
    for remat in ("none", "full"):
        run = _run("mcast", remat=remat)
        api, ctx, _ = make_train_step(run, mesh, device="cpu")
        state = init_state(run, mesh, tree, device="cpu")
        with use_ctx(ctx):
            loss, _ = api.loss_fn(at_use(state.params, 2, ("data",)), batch)
            leaves = [s.local for s in tree_leaves(state.params)]
            out[remat] = (loss, torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        build_model(SMALL, remat="offload", device="cpu")


def test_chunked_xent_global_token_mean():
    """Chunks of 5 over 12 positions with masked targets: the NLL summed
    over every rank and divided by the global count of unmasked tokens."""
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(2, 3, 12, 8, generator=gen)
    head = torch.randn(2, 8, 11, generator=gen)
    t = torch.randint(0, 11, (2, 3, 12), generator=gen)
    t[0, 0, :7] = -1
    t[1, 2, 3] = -1
    logits = torch.einsum("rbsd,rdv->rbsv", h, head)
    nll = torch.nn.functional.cross_entropy(logits.flatten(0, 2), t.flatten(),
                                            ignore_index=-1, reduction="sum")
    want = nll / (t >= 0).sum()
    torch.testing.assert_close(chunked_xent(h, head, t, chunk=5), want)


def test_adamw_matches_reference():
    """lr_schedule, clipping and one AdamW update against the reference's on
    one tree (one rank, no mesh)."""
    tc = TrainConfig(steps=20, warmup_steps=4, grad_clip=0.5)
    ref_tc = RefTrainConfig(steps=20, warmup_steps=4, grad_clip=0.5)
    for s in range(0, 22):
        assert adamw.lr_schedule(s, tc) == pytest.approx(
            float(ref_adamw.lr_schedule(jnp.int32(s), ref_tc)), rel=1e-6, abs=1e-12)
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = {"w": rng.standard_normal((4, 6)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}}

    def stacked(t):
        return {k: stacked(v) if isinstance(v, dict)
                else Stacked(torch.from_numpy(v.copy())[None], ()) for k, v in t.items()}

    params, opt = stacked(tree), adamw.init(stacked(tree))
    ref_params = {"w": jnp.asarray(tree["w"]), "b": {"c": jnp.asarray(tree["b"]["c"])}}
    ref_grads = {"w": jnp.asarray(grads["w"]), "b": {"c": jnp.asarray(grads["b"]["c"])}}
    ref_opt = ref_adamw.init(ref_params)
    for _ in range(2):
        params, opt, m = adamw.apply_updates(params, stacked(grads), opt, tc)
        ref_params, ref_opt, rm = ref_adamw.apply_updates(ref_params, ref_grads, ref_opt, ref_tc)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
    np.testing.assert_allclose(params["w"].local[0].numpy(), np.asarray(ref_params["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.v["b"]["c"].local[0].numpy(),
                               np.asarray(ref_opt.v["b"]["c"]), rtol=1e-6)
    assert opt.step == 2


# ----------------------------- ports of tests/test_train_integration.py:24,37


def _small_run(mode="xla", grad_accum=1, steps=30) -> RunConfig:
    return RunConfig(model=SMALL, shape=ShapeConfig("t", "train", 64, 8),
                     train=TrainConfig(steps=steps, grad_accum=grad_accum,
                                       learning_rate=1e-2, warmup_steps=2),
                     collective=CollectiveConfig(fsdp_mode=mode))


@pytest.mark.parametrize("mesh", [None, StackedMesh(data=8, model=1)], ids=["one", "dp8"])
def test_loss_descends(mesh):
    run = _small_run("mcast")
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, bridge.random_params(SMALL, 0), device="cpu")
    pipe = SyntheticPipeline(SMALL, run.shape, device="cpu")
    losses = []
    for i in range(30):
        state, m = step(state, pipe.next_batch(i))
        losses.append(float(m["loss"]))
    assert min(losses[-5:]) < losses[0] - 0.3, losses[:3] + losses[-3:]


@pytest.mark.parametrize("mesh", [None, StackedMesh(data=2, model=1)], ids=["one", "dp2"])
def test_grad_accum_equivalence(mesh):
    """accum=2 on the same global batch gives (nearly) the same first step."""
    pipe = SyntheticPipeline(SMALL, _small_run().shape, device="cpu")
    batch = pipe.next_batch(0)
    results = {}
    for a in (1, 2):
        run = _small_run("mcast_ring", grad_accum=a)
        _, _, step = make_train_step(run, mesh, device="cpu")
        state = init_state(run, mesh, bridge.random_params(SMALL, 0), device="cpu")
        _, m = step(state, batch)
        results[a] = (float(m["loss"]), float(m["grad_norm"]))
    assert results[1][0] == pytest.approx(results[2][0], rel=1e-5)
    assert results[1][1] == pytest.approx(results[2][1], rel=1e-3)


def test_train_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import train
    before = (K.launches, K.allgather_launches, K.allgather_transpose_launches, M.launches)
    train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "2",
                "--fsdp-mode", "mcast_bcast"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "[train] done" in out
    assert (K.launches, K.allgather_launches, K.allgather_transpose_launches,
            M.launches) == before  # CPU: plain versions
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1"])

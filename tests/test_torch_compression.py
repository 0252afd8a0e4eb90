"""The port's gradient compression (``optim/compression.py``) against the
JAX package's: blockwise int8 with error feedback, the reference's op for
op in plain torch.

The reference runs in this process on one device. The same numpy inputs go
to both. ``compress_leaf``'s outputs are held bitwise, except that one int8
level apart is allowed where the two quantize a value at a rounding tie (as
for the int8 KV cache): there the two g_hat differ by their block's scale
and the two residuals by minus that. ``make_compressor`` on the port's
stacked tree of a reduced smollm-135m on ``(data=8)`` is held against the
reference's on its global tree. Three AdamW steps with compression between
backward and update, on one rank and on ``(data=8)``, against the
reference's jitted step: loss within 1e-5, parameters within 1e-5.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RefTrainConfig
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch import bridge
from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh
from repro_torch.optim import adamw, compression
from repro_torch.runtime.train_loop import TrainState, init_state, make_train_step
from repro_torch.sharding.fsdp import global_tensor, trainable
from repro_torch.sharding.specs import Stacked, tree_leaves, tree_map_with_path
from test_torch_support import SMALL, flatten, one_torch_thread, random_tree  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MESH = StackedMesh(data=8, model=1)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _same_up_to_ties(got_hat, got_err, want_hat, want_err, block: int) -> int:
    """g_hat and the residual bitwise, or one int8 level apart where the two
    rounded at a tie (each differing by the block's scale, with opposite
    signs, so that g_hat + err agrees). Returns the elements one level
    apart."""
    gh, ge, wh, we = (_np(a).reshape(-1) for a in (got_hat, got_err, want_hat, want_err))
    off = np.flatnonzero((gh != wh) | (ge != we))
    if off.size:
        g32 = (wh.astype(np.float32) + we)                   # the quantized input
        pad = np.pad(np.abs(g32), (0, -g32.size % block)).reshape(-1, block)
        scale = np.maximum(pad.max(1) / np.float32(127.0), np.float32(1e-12))[off // block]
        np.testing.assert_allclose(np.abs(gh[off] - wh[off]), scale, rtol=1e-6)
        np.testing.assert_allclose(gh[off] + ge[off], wh[off] + we[off], rtol=0, atol=1e-6)
        frac = np.abs(g32[off] / scale) % 1.0
        np.testing.assert_allclose(frac, 0.5, atol=1e-3)
    return off.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("shape", [(100,), (128,), (256,), (1000,), (3, 300), (4, 2, 64)])
def test_compress_leaf_matches_reference(shape, block, dtype):
    """One round from a zero residual, then a second from the first's
    residual, below, at and off a multiple of the block."""
    rng = np.random.default_rng(zlib.crc32(repr((shape, block, dtype)).encode()))
    g = [(rng.standard_normal(shape) * 0.01).astype(np.float32) for _ in range(2)]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    err_t, err_j = torch.zeros(shape), jnp.zeros(shape, jnp.float32)
    for gi in g:
        ht, err_t2 = compression.compress_leaf(torch.from_numpy(gi).to(tdt), err_t, block)
        hj, err_j2 = ref_comp.compress_leaf(jnp.asarray(gi, jdt), err_j, block)
        assert ht.dtype == tdt and err_t2.dtype == torch.float32 and ht.shape == shape
        assert _same_up_to_ties(ht, err_t2, hj, err_j2, block) == 0
        err_t, err_j = err_t2, err_j2


def test_quant_blocks_match_reference():
    """The int8 codes and the per-block scales themselves, at an exact tie
    (x / scale = 0.5 and 2.5: half to even gives 0 and 2) and at all zeros
    (scale clamped to 1e-12)."""
    x = np.zeros(300, np.float32)
    x[:4] = [127.0, 0.5, 2.5, -3.5]
    qt, st, nt = compression._quant_block_int8(torch.from_numpy(x), 256)
    qj, sj, nj = ref_comp._quant_block_int8(jnp.asarray(x), 256)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert nt == nj == 300 and qt.dtype == torch.int8
    assert qt[0, 1] == 0 and qt[0, 2] == 2 and st[1, 0] == np.float32(1e-12)


def test_error_feedback_sum_matches_reference():
    """The reference's 50-step error-feedback sum (test_compression.py), in
    both packages on the same gradients: every step's g_hat and residual
    equal, the drift of the port's sum under 1e-5."""
    rng = np.random.default_rng(1)
    true_sum, comp_sum = torch.zeros(512), torch.zeros(512)
    err_t, err_j = torch.zeros(512), jnp.zeros((512,))
    ties = 0
    for i in range(50):
        g = (rng.standard_normal(512) * (0.1 / (i + 1))).astype(np.float32)
        ht, err_t2 = compression.compress_leaf(torch.from_numpy(g), err_t, 128)
        hj, err_j2 = ref_comp.compress_leaf(jnp.asarray(g), err_j, 128)
        ties += _same_up_to_ties(ht, err_t2, hj, err_j2, 128)
        true_sum += torch.from_numpy(g)
        comp_sum += ht
        err_t, err_j = err_t2, jnp.asarray(err_t2.numpy())
    assert ties == 0
    assert float(torch.max(torch.abs(comp_sum + err_t - true_sum))) < 1e-5


@pytest.mark.parametrize("args", [(), (32, 256), (16, 128), (32, 64), (8, 32)])
def test_compression_ratio_matches_reference(args):
    assert compression.compression_ratio(*args) == ref_comp.compression_ratio(*args)


def test_make_compressor_on_the_stacked_tree():
    """The port's trainable tree of a reduced smollm-135m on (data=8): every
    split leaf (N, *local) quantized in the reference's blocks of its
    global array, twice (the second round from the first's residuals);
    each leaf's global tensor of g_hat and of the residual against the
    reference's make_compressor on the global tree."""
    tree = random_tree(SMALL, 3)
    grads = [{k: v * 0.01 for k, v in flatten(tree).items()},
             {k: v * -0.003 for k, v in flatten(random_tree(SMALL, 4)).items()}]
    stacked = trainable(bridge.to_torch(tree, MESH, MeshConfig(), dtype=torch.float32,
                                        device="cpu"), ("data",))
    assert any(s.local.shape[0] == 8 and s.spec and s.spec[0] is None
               for s in tree_leaves(stacked))   # a leaf split off its first dim
    comp, err = compression.make_compressor(stacked, block=256)
    ref_fn, ref_err = ref_comp.make_compressor(jax.tree.map(jnp.asarray, tree), block=256)

    def as_grads(flat):
        return tree_map_with_path(lambda path, leaf: _split_like(leaf, flat["/".join(path)]),
                                  stacked)

    for flat in grads:
        g_hat, err = comp(as_grads(flat), err)
        ref_tree = _unflat(flat)
        want_hat, ref_err = ref_fn(jax.tree.map(jnp.asarray, ref_tree), ref_err)
        want_hat, want_err = flatten(jax.tree.map(np.asarray, want_hat)), flatten(
            jax.tree.map(np.asarray, ref_err))
        for key, leaf in _paths(g_hat):
            e = dict(_paths(err))[key]
            assert e.local.dtype == torch.float32 and e.local.shape == leaf.local.shape
            assert _same_up_to_ties(global_tensor(leaf), global_tensor(e), want_hat[key],
                                    want_err[key], 256) == 0, key


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _unflat(flat: dict) -> dict:
    tree = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


def _split_like(leaf: Stacked, a: np.ndarray) -> Stacked:
    """The global array ``a`` in the trainable layout of ``leaf``."""
    from repro_torch.sharding.fsdp import split_global
    t = torch.from_numpy(np.ascontiguousarray(a))
    return leaf._replace(local=split_global(t, leaf.spec, leaf.mesh) if leaf.mesh else t)


# ---------------------------------------- AdamW with compression in the loop

SHAPE = ShapeConfig("t", "train", 64, 8)
STEPS = 3
TC = dict(steps=25, learning_rate=1e-2, warmup_steps=2)


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's jitted step with compression between backward and
    update (its test_training_with_compression_descends), one device, from
    the bridged parameters, on the port's batches: each step's loss,
    gradients, the quantizer's inputs (gradients plus residual) and
    compressed gradients, and the parameters after the last."""
    tree = random_tree(SMALL, 5)
    pipe = SyntheticPipeline(SMALL, SHAPE, device="cpu")
    batches = [pipe.next_batch(i) for i in range(STEPS)]
    api = ref_build_model(_ref_cfg())
    tc = RefTrainConfig(**TC)
    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_adamw.init(params)
    comp, err = ref_comp.make_compressor(params)

    @jax.jit
    def step(params, opt, err, batch):
        (loss, _), grads = jax.value_and_grad(api.loss_fn, has_aux=True)(params, batch)
        pre = jax.tree.map(lambda g, e: g.astype(jnp.float32) + e, grads, err)
        g_hat, err = comp(grads, err)
        params, opt, _ = ref_adamw.apply_updates(params, g_hat, opt, tc)
        return params, opt, err, loss, grads, pre, g_hat

    steps = []
    for b in batches:
        params, opt, err, loss, grads, pre, g_hat = step(params, opt, err, {
            k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in b.items()})
        steps.append((float(loss), *(flatten(jax.tree.map(np.asarray, t))
                                     for t in (grads, pre, g_hat))))
    return tree, batches, steps, flatten(jax.tree.map(np.asarray, params))


def _ref_cfg():
    from repro.configs import get_model_config, reduced
    return reduced(get_model_config("smollm-135m"))


def _flips(pre: np.ndarray, want_pre: np.ndarray, block: int, before) -> np.ndarray:
    """The int8 codes of two quantizer inputs that agree to f32 rounding
    (the port's and the reference's, each by its own package): equal, or
    one level apart where the rounding tie between the two codes lies
    between the two inputs' levels (the difference of the inputs explains
    the flip); an element that flipped at an earlier step (``before``) is
    free, its residual carrying the old level back. Asserts that; returns
    the mask of the elements whose codes differ."""
    q, s, _ = compression._quant_block_int8(torch.from_numpy(pre), block)
    qj, sj, _ = ref_comp._quant_block_int8(jnp.asarray(want_pre), block)
    q, qj = q.numpy().astype(np.int32).reshape(-1), np.asarray(qj, np.int32).reshape(-1)
    off = np.flatnonzero(q != qj)
    was = np.pad(np.broadcast_to(before, pre.shape).reshape(-1), (0, q.size - pre.size))
    new = off[~was[off]]
    np.testing.assert_array_equal(np.abs(q[new] - qj[new]), 1)
    pad = q.size - pre.size
    level = np.pad(pre.reshape(-1), (0, pad))[new] / s.numpy().reshape(-1)[new // block]
    level_ref = (np.pad(want_pre.reshape(-1), (0, pad))[new]
                 / np.asarray(sj).reshape(-1)[new // block])
    tie = (q[new] + qj[new]) / 2
    assert np.all(np.abs(level - tie) <= np.abs(level - level_ref) + 1e-6)
    mask = np.zeros(q.size, bool)
    mask[off] = True
    return mask[:pre.size].reshape(pre.shape)


@pytest.mark.parametrize("mesh", [None, MESH], ids=["one-rank", "data8"])
def test_adamw_with_compression_matches_reference(reference_steps, mesh):
    """Each step's loss within 1e-5 and gradients within 1e-5 of the
    reference's; the quantizer's inputs within 1e-5 and their int8 codes
    equal but where the two inputs, f32 sums in another order, straddle a
    rounding tie (``_flips``); the compressed gradients within 1e-5; the
    parameters after 3 steps within 1e-5, and within 3 x the learning rate
    (one AdamW step's reach) at a flipped element, of which there are
    few."""
    tree, batches, steps, want_params = reference_steps
    run = RunConfig(model=SMALL, shape=SHAPE, train=TrainConfig(**TC))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    comp, err = compression.make_compressor(state.params)
    flipped: dict[str, np.ndarray] = {}
    for b, (want_loss, want_grads, want_pre, want_hat) in zip(batches, steps):
        loss, _, grads = step.value_and_grad(state, b)
        assert abs(float(loss) - want_loss) <= 1e-5, (float(loss), want_loss)
        pre = {k: global_tensor(g).numpy() + global_tensor(e).numpy()
               for (k, g), (_, e) in zip(_paths(grads), _paths(err))}
        g_hat, err = comp(grads, err)
        for key, g in _paths(grads):
            np.testing.assert_allclose(global_tensor(g).numpy(), want_grads[key], rtol=0,
                                       atol=1e-5, err_msg=key)
        for key, g in _paths(g_hat):
            before = np.broadcast_to(flipped.get(key, False), pre[key].shape)
            diff = np.abs(pre[key] - want_pre[key])
            assert float(np.max(diff[~before], initial=0.0)) <= 1e-5, key
            mask = _flips(pre[key], want_pre[key], 256, before)
            flipped[key] = before | mask
            diff = np.abs(global_tensor(g).numpy() - want_hat[key])
            assert float(np.max(diff[~mask], initial=0.0)) <= 1e-5, key
        params, opt, _ = adamw.apply_updates(state.params, g_hat, state.opt, run.train)
        state = TrainState(params, opt)
    got = flatten(bridge.to_numpy(_ranked(state.params, mesh), mesh, MeshConfig()))
    assert sorted(got) == sorted(want_params)
    n = sum(a.size for a in got.values())
    assert sum(int(np.sum(m)) for m in flipped.values()) <= n // 1000
    for key, a in got.items():
        diff = np.abs(a - want_params[key])
        keep = ~np.broadcast_to(flipped.get(key, False), a.shape)
        assert float(np.max(diff[keep], initial=0.0)) <= 1e-5, key
        assert float(np.max(diff, initial=0.0)) <= 3 * TC["learning_rate"], key


def _ranked(params, mesh):
    from repro_torch.sharding.fsdp import at_use
    return at_use(params, 1 if mesh is None else mesh.n_ranks, ("data",))

"""The collective layer's remaining entry points of the PyTorch port held
against the JAX package on the same seeded numpy inputs: the
allgather-fused matmul (``make_allgather_matmul``, kernel #4), the
pipelined Broadcast, concurrent AG/RS, ``flatten_bucket`` and the
``kernels.ops`` wrappers.

The reference runs on an 8-device CPU mesh in one subprocess per module
(``run_reference``), its Pallas matmul in interpret mode, as its own tests
run it. Tolerances: the allgather-matmul within the reference's own 1e-3 in
f32 (tests/test_kernels.py:101) and 0.5 in bf16 (the limit of
tests/test_torch_matmul.py: both sum in f32 and round once, in other
orders); everything that only moves data, bitwise. Within the port, the
allgather-matmul equals the plain gather followed by one ``matmul``,
bitwise.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.sharding.fsdp import flatten_bucket as ref_flatten_bucket
from repro_torch import bridge
from repro_torch.core import collectives as C
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ops
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.fsdp import flatten_bucket
from test_torch_support import SMALL, run_reference

P8 = 8
AGMM = [(dt, m, k, n, up) for dt, m, k, n, up in itertools.product(
    ("float32", "bfloat16"), (8, 16), (64, 128), (32, 128), (True, False))]
GROUPS = (2, 4, 8, 64, 32)   # pod, data, m, K, N of the grouped case
ROOTS, CHUNKS, BCAST_N = (0, 3, 7), (1, 4, 8, 16), 64
AG_N, RS_M = 6, 5
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-3, "bfloat16": 0.5}


def _agmm_key(dt, m, k, n, up):
    return f"agmm_{dt}_{m}_{k}_{n}_{int(up)}"


@pytest.fixture(scope="module")
def ref():
    """Every reference output of this module, from one subprocess."""
    rng = np.random.default_rng(0)
    inputs = {}
    for dt, m, k, n, up in AGMM:
        key = _agmm_key(dt, m, k, n, up)
        inputs[key + "_x"] = rng.standard_normal((P8 * m, k)).astype(np.float32)
        inputs[key + "_w"] = rng.standard_normal((k, n)).astype(np.float32)
    pod, data, gm, gk, gn = GROUPS
    inputs["grp_x"] = rng.standard_normal((pod * data * gm, gk)).astype(np.float32)
    inputs["grp_w"] = rng.standard_normal((gk, gn)).astype(np.float32)
    inputs["bcast_x"] = rng.standard_normal(P8 * BCAST_N).astype(np.float32)
    inputs["ag"] = rng.standard_normal(P8 * AG_N).astype(np.float32)
    inputs["rs"] = rng.standard_normal((P8, P8 * RS_M)).astype(np.float32)
    body = f'''
import functools
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat
from repro.core import collectives as C
from repro.kernels import ops
from repro.kernels.collective_matmul import allgather_matmul_local
mesh = ref_mesh(({P8},), ("x",))
for key in [k[:-2] for k in IN if k.startswith("agmm_") and k.endswith("_x")]:
    _, dt, m, k, n, up = key.split("_")
    x = jax.device_put(jnp.asarray(IN[key + "_x"], dt), NamedSharding(mesh, P("x")))
    w = jnp.asarray(IN[key + "_w"], dt)
    y = ops.make_allgather_matmul(mesh, "x", use_pallas=bool(int(up)))(x, w)
    OUT[key] = np.asarray(y.astype(jnp.float32))
# two groups: the reference's local function over "data", pods independent
gmesh = ref_mesh({GROUPS[:2]}, ("pod", "data"))
local = functools.partial(allgather_matmul_local, axis="data")
sm = compat.shard_map(local, mesh=gmesh, in_specs=(P(("pod", "data")), P()),
                      out_specs=P("pod"), check_vma=False)
OUT["grp"] = np.asarray(jax.jit(sm)(jnp.asarray(IN["grp_x"]), jnp.asarray(IN["grp_w"])))
xb = jax.device_put(IN["bcast_x"], NamedSharding(mesh, P("x")))
for root in {ROOTS}:
    for nc in {CHUNKS}:
        OUT[f"bcast_{{root}}_{{nc}}"] = np.asarray(
            C.make_broadcast(mesh, "x", root=root, n_chunks=nc)(xb))
fn = lambda a, r: compat.shard_map(
    lambda aa, rr: C.concurrent_ag_rs_local(aa, rr[0], "x"), mesh=mesh,
    in_specs=(P("x"), P("x")), out_specs=(P(), P("x")), check_vma=False)(a, r)
agf, rss = jax.jit(fn)(jax.device_put(IN["ag"], NamedSharding(mesh, P("x"))),
                       jnp.asarray(IN["rs"]))
OUT["ag"], OUT["rs"] = np.asarray(agf), np.asarray(rss)
'''
    return inputs, run_reference(body, inputs)


# ------------------------------------------------ allgather-matmul (#4)


def _gather_then_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (P, m, K) -> every rank's gathered rows times w, on ``matmul``."""
    p, m, k = x.shape
    rows = C.plain_allgather_local(x.reshape(p, m * k)).reshape(p, p * m, k)
    return M.matmul(rows, w.expand(p, k, w.shape[1]))


@pytest.mark.parametrize("dt,m,k,n,use_pallas", AGMM)
def test_allgather_matmul_matches_jax(ref, dt, m, k, n, use_pallas):
    """make_allgather_matmul on an 8-rank stacked mesh against the
    reference's on an 8-device mesh; every rank's copy within the
    reference's limit, and bitwise equal to gather-then-matmul."""
    inputs, out = ref
    key = _agmm_key(dt, m, k, n, use_pallas)
    x = torch.from_numpy(inputs[key + "_x"]).to(TORCH[dt]).reshape(P8, m, k)
    w = torch.from_numpy(inputs[key + "_w"]).to(TORCH[dt])
    before = (K.launches, M.launches)
    got = M.make_allgather_matmul(StackedMesh(x=P8), "x", use_pallas=use_pallas)(x, w)
    assert (K.launches, M.launches) == before   # CPU tensors take the plain versions
    assert got.shape == (P8, P8 * m, n) and got.dtype == TORCH[dt]
    for r in range(P8):
        np.testing.assert_allclose(got[r].float().numpy(), out[key], atol=TOL[dt], rtol=0)
    assert torch.equal(got, _gather_then_matmul(x, w))


def test_allgather_matmul_two_groups_matches_jax(ref):
    """On (pod=2, data=4) each pod gathers its own four shards over
    ``data``: the reference's local function under shard_map, pods apart."""
    inputs, out = ref
    pod, data, m, k, n = GROUPS
    x = torch.from_numpy(inputs["grp_x"]).reshape(pod * data, m, k)
    w = torch.from_numpy(inputs["grp_w"])
    got = M.make_allgather_matmul(StackedMesh(pod=pod, data=data, model=1), "data")(x, w)
    assert got.shape == (pod * data, data * m, n)
    want = out["grp"].reshape(pod, data * m, n)
    for r in range(pod * data):
        np.testing.assert_allclose(got[r].numpy(), want[r // data], atol=1e-3, rtol=0)
        group = x[r // data * data:(r // data + 1) * data]
        assert torch.equal(got[r], _gather_then_matmul(group, w)[0])


@pytest.mark.parametrize("p,m,k,n", [(2, 3, 5, 7), (3, 8, 33, 16), (5, 2, 16, 40),
                                     (8, 16, 576, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allgather_matmul_is_gather_then_matmul(p, m, k, n, dtype):
    """Odd ranks, rows and widths, and smollm-135m's 576 -> 192: the
    stepwise products on diagonal views equal one product of the gathered
    rows, bitwise; use_pallas=False is the same f32-summed product."""
    gen = torch.Generator().manual_seed(p * m + k)
    x = torch.randn(p, m, k, generator=gen).to(dtype)
    w = torch.randn(k, n, generator=gen).to(dtype)
    want = _gather_then_matmul(x, w)
    assert torch.equal(M.allgather_matmul_local(x, w, bm=1, bk=1, bn=1), want)
    assert torch.equal(M.allgather_matmul_local(x, w, use_pallas=False), want)


def test_allgather_matmul_single_row_within_rounding():
    """m = 1: torch's CPU product of a single row sums in another order than
    that of the gathered rows, so on the CPU the two agree within f32
    rounding (on the card the kernel gives the same bits either way)."""
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(8, 1, 64, generator=gen), torch.randn(64, 32, generator=gen)
    torch.testing.assert_close(M.allgather_matmul_local(x, w), _gather_then_matmul(x, w),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("tiles", [dict(bm=3), dict(bk=48), dict(bn=24), dict(bm=0)])
def test_allgather_matmul_refuses_what_the_reference_asserts(tiles):
    """m = 8, K = 64, N = 32: tiles that do not divide are refused where
    matmul_pallas asserts; the jnp.dot branch takes any tiles."""
    x, w = torch.zeros(4, 8, 64), torch.zeros(64, 32)
    with pytest.raises(ValueError, match="tile"):
        M.allgather_matmul_local(x, w, **tiles)
    assert M.allgather_matmul_local(x, w, use_pallas=False, **tiles).shape == (4, 32, 32)
    with pytest.raises(NotImplementedError, match="backward"):
        M.allgather_matmul_local(x, w.requires_grad_())


def test_smollm_widths_need_tiles_that_divide():
    """K = 576 and N = 192 (smollm-135m's q and kv projections): matmul_pallas
    asserts at its default 128 tiles and so does the port's precondition;
    both take bk = bn = 64."""
    from repro.kernels.collective_matmul import matmul_pallas
    x, w = np.zeros((8, 576), np.float32), np.zeros((576, 192), np.float32)
    with pytest.raises(AssertionError):
        matmul_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True)
    with pytest.raises(ValueError, match="k=576"):
        M.allgather_matmul_local(torch.zeros(2, 8, 576), torch.from_numpy(w))
    matmul_pallas(jnp.asarray(x), jnp.asarray(w), bk=64, bn=64, interpret=True)
    got = M.allgather_matmul_local(torch.zeros(2, 8, 576), torch.from_numpy(w), bk=64, bn=64)
    assert got.shape == (2, 16, 192)


def test_matmul_into_diagonal_views():
    """``out=`` takes strided views: the two diagonals of one step, each
    equal to the product of contiguous copies."""
    gen = torch.Generator().manual_seed(1)
    p, m, k, n = 4, 3, 8, 5
    buf = torch.randn(p, p, m, k, generator=gen)
    w = torch.randn(k, n, generator=gen)
    out = torch.zeros(p, p, m, n)
    assert not M._diagonals(out, 1)[0].is_contiguous()
    for a, y in zip(M._diagonals(buf, 1), M._diagonals(out, 1)):
        M.matmul(a, w.expand(a.shape[0], k, n), out=y)
        assert torch.equal(y, M.matmul(a.contiguous(), w.expand(a.shape[0], k, n)))
    touched = torch.zeros(p, p, dtype=torch.bool)
    for d in range(p):
        touched[d, (d - 1) % p] = True
    assert torch.equal((out != 0).any(-1).any(-1), touched)
    with pytest.raises(ValueError, match="out must be"):
        M.matmul(buf[0], w.expand(p, k, n), out=torch.zeros(p, m, n + 1))


# --------------------------------------------------------------- broadcast


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("n_chunks", CHUNKS)
def test_broadcast_matches_jax(ref, root, n_chunks):
    """The grid of tests/test_collectives.py:63-78, bitwise: every rank
    holds root's row."""
    inputs, out = ref
    x = torch.from_numpy(inputs["bcast_x"]).reshape(P8, BCAST_N)
    got = C.make_broadcast(StackedMesh(x=P8), "x", root=root, n_chunks=n_chunks)(x)
    assert got.shape == (P8, BCAST_N)
    for r in range(P8):
        np.testing.assert_array_equal(got[r].numpy(), out[f"bcast_{root}_{n_chunks}"])
        assert torch.equal(got[r], x[root])


def test_broadcast_over_groups_and_bad_chunks():
    """(pod=2, data=4): each pod broadcasts its own root's row; a length
    that does not split into the chunks raises, where the reference asserts."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    got = C.make_broadcast(StackedMesh(pod=2, data=4, model=1), "data", root=1,
                           n_chunks=3)(x)
    for r in range(8):
        assert torch.equal(got[r], x[r // 4 * 4 + 1])
    with pytest.raises(ValueError, match="chunks"):
        C.pipelined_broadcast_local(x, n_chunks=5)


# ------------------------------------------------------ concurrent AG / RS


def test_concurrent_ag_rs_matches_jax(ref):
    """Both halves bitwise equal to the reference's concurrent_ag_rs_local
    and to the port's separate calls."""
    inputs, out = ref
    ag = torch.from_numpy(inputs["ag"]).reshape(P8, AG_N)
    rs = torch.from_numpy(inputs["rs"])
    got_ag, got_rs = C.concurrent_ag_rs_local(ag, rs)
    assert got_ag.shape == (P8, P8 * AG_N) and got_rs.shape == (P8, RS_M)
    for r in range(P8):
        np.testing.assert_array_equal(got_ag[r].numpy(), out["ag"])
    np.testing.assert_array_equal(got_rs.reshape(-1).numpy(), out["rs"])
    assert torch.equal(got_ag, C.ring_allgather_local(ag))
    assert torch.equal(got_rs, C.ring_reduce_scatter_local(rs, direction=-1))


@pytest.mark.parametrize("overlap", [False, True])
def test_concurrent_ag_rs_both_stream_paths_match_jax(ref, overlap, monkeypatch):
    """Both of ``_concurrent_ag_rs``'s paths on the CPU: the gather as one
    ``ring_allgather`` of the whole ring schedule into a new buffer, and the
    reduce-scatter as one ``ring_allgather_transpose`` of the same schedule,
    bitwise equal to the reference. A CPU tensor has no side stream
    (``device.SideStream`` runs the gather in place), so the two-stream path
    runs the same calls in the same order."""
    inputs, out = ref
    ag = torch.from_numpy(inputs["ag"]).reshape(P8, AG_N)
    rs = torch.from_numpy(inputs["rs"])
    calls = []
    gather, transpose = C.ring_allgather, C.ring_allgather_transpose
    monkeypatch.setattr(C, "ring_allgather",
                        lambda x, schedule, out=None: calls.append(("gather", schedule))
                        or gather(x, schedule, out))
    monkeypatch.setattr(C, "ring_allgather_transpose",
                        lambda g, schedule: calls.append(("transpose", schedule))
                        or transpose(g, schedule))
    got_ag, got_rs = C._concurrent_ag_rs(ag, rs, overlap=overlap)
    assert calls == [("gather", C._ring_schedule(P8)), ("transpose", C._ring_schedule(P8))]
    for r in range(P8):
        np.testing.assert_array_equal(got_ag[r].numpy(), out["ag"])
    np.testing.assert_array_equal(got_rs.reshape(-1).numpy(), out["rs"])


def test_concurrent_ag_rs_checks_its_inputs():
    with pytest.raises(ValueError):
        C.concurrent_ag_rs_local(torch.zeros(4, 3), torch.zeros(4, 10))
    with pytest.raises(NotImplementedError, match="backward"):
        C.concurrent_ag_rs_local(torch.zeros(4, 3, requires_grad=True), torch.zeros(4, 8))


# ------------------------------------------------------------ flatten_bucket


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("pad_to", [1, 8, 64])
def test_flatten_bucket_matches_jax(pad_to):
    """The reduced smollm-135m tree (its dicts in an unsorted insertion
    order) gives the reference's bucket element for element, and
    unflatten gives the tree back."""
    tree = bridge.random_params(SMALL, 0)
    assert list(tree) != sorted(tree) and list(tree["blocks"]) != sorted(tree["blocks"])
    tree["extra"] = [np.arange(5, dtype=np.float32), (np.ones((2, 3), np.float32),)]
    want, _ = ref_flatten_bucket(_tree_map(jnp.asarray, tree), pad_to=pad_to)
    got, unflatten = flatten_bucket(_tree_map(torch.from_numpy, tree), pad_to=pad_to)
    assert got.dtype == torch.float32 and got.shape[0] % pad_to == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = unflatten(got)
    assert list(back) == list(tree)
    assert torch.equal(back["blocks"]["attn"]["wq"], torch.from_numpy(tree["blocks"]["attn"]["wq"]))
    assert torch.equal(back["extra"][1][0], torch.ones(2, 3))
    assert isinstance(back["extra"], list) and isinstance(back["extra"][1], tuple)


def test_flatten_bucket_keeps_dtypes():
    tree = {"b": torch.ones(3, dtype=torch.bfloat16), "a": torch.arange(4)}
    flat, unflatten = flatten_bucket(tree, pad_to=8)
    assert torch.equal(flat, torch.tensor([0, 1, 2, 3, 1, 1, 1, 0], dtype=torch.float32))
    back = unflatten(flat)
    assert back["b"].dtype == torch.bfloat16 and back["a"].dtype == torch.int64
    assert torch.equal(back["a"], tree["a"])


# ----------------------------------------------------------------- kernels.ops


def test_ops_exports_the_reference_names():
    assert ops.__all__ == ref_ops.__all__
    for name in ops.__all__:
        assert callable(getattr(ops, name))


def test_ops_wrappers_match_the_reference():
    """The 2-D matmul, bitmap pack / popcount and reassembly on CPU tensors
    against the reference's jitted wrappers (interpret mode)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((128, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    np.testing.assert_allclose(ops.matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(ref_ops.matmul(x, w)), atol=2e-3, rtol=0)
    flags = (rng.random(2048) < 0.3).astype(np.uint32)
    words = ops.pack_bitmap(torch.from_numpy(flags.astype(np.int32)), block_words=16)
    ref_words = ref_ops.pack_bitmap(jnp.asarray(flags), block_words=16)
    np.testing.assert_array_equal(words.view(torch.int32).numpy(),
                                  np.asarray(ref_words).view(np.int32))
    assert int(ops.popcount(words, block=64)) == int(ref_ops.popcount(ref_words, block=64))
    staging = rng.standard_normal((6, 16)).astype(np.float32)
    psn = np.array([3, 0, 5, 3, 1, 7], np.int32)
    user = np.zeros((8, 16), np.float32)
    got_user, got_bits = ops.reassemble(torch.from_numpy(staging), torch.from_numpy(psn),
                                        torch.from_numpy(user.copy()), 5)
    want_user, want_bits = ref_ops.reassemble(staging, psn, user, 5)
    np.testing.assert_array_equal(got_user.numpy(), np.asarray(want_user))
    np.testing.assert_array_equal(got_bits.view(torch.int32).numpy(),
                                  np.asarray(want_bits).view(np.int32))


@pytest.mark.parametrize("call", [
    lambda: ops.matmul(torch.zeros(8, 64), torch.zeros(64, 32), bm=3),
    lambda: ops.matmul_pallas(torch.zeros(8, 64), torch.zeros(64, 32), bk=48),
    lambda: ops.pack_bitmap(torch.zeros(96, dtype=torch.int32), block_words=2),
    lambda: ops.popcount(torch.zeros(6, dtype=torch.uint32), block=4),
])
def test_ops_refuse_what_the_reference_asserts(call):
    with pytest.raises(ValueError, match="tile"):
        call()


def test_ops_interpret_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="interpret"):
        ops.matmul(torch.zeros(8, 8), torch.zeros(8, 8), interpret=True)
    assert ops.matmul(torch.ones(8, 8), torch.ones(8, 8), interpret=None)[0, 0] == 8

"""The backwards of the port's allgather-fused matmul and concurrent AG/RS,
held against ``jax.vjp`` of the JAX package's on the same seeded numpy
inputs and cotangents.

The reference has no ``custom_vjp``, so ``jax.vjp`` of
``allgather_matmul_local`` works only on its ``use_pallas=False``
(``jnp.dot``) branch: its Pallas branch has no vjp. Both of the port's
branches are held against that one, within the reference's own
allgather-matmul limits, 1e-3 in f32 and 0.5 in bf16.

Cotangent mapping: the reference runs under a shard_map whose
``out_specs`` is ``P('x')``, so each device's gathered copy is its own
output with its own cotangent, as the port's stacked output (P, P m, N)
gives each rank's copy its own. ``w`` goes in per device, stacked
(P K, N) under ``in_specs=P('x')``, and the port's dw (the sum over ranks,
of one replicated w) is compared with the sum of the devices' dw.
Concurrent AG/RS takes ``ag`` and ``rs`` per device under ``P('x')`` too;
its backward must equal the separate calls' backwards bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import collectives as C
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from test_torch_support import run_reference

P8 = 8
M_ROWS, K_IN, N_OUT = 8, 64, 32
DTYPES = ("float32", "bfloat16")
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-3, "bfloat16": 0.5}
GROUPS = (2, 4)                     # (pod, data) of the two-group case
AG_N, RS_M = 6, 5


def _launches() -> tuple:
    return (K.allgather_launches, K.allgather_transpose_launches, K.launches, M.launches,
            M.launches_wmma, M.launches_f32, M.allgather_launches)


@pytest.fixture(scope="module")
def ref():
    """jax.vjp of the reference's allgather-matmul (jnp.dot branch) on one
    8-device axis and on (pod=2, data=4), and of its concurrent AG/RS, from
    one subprocess."""
    rng = np.random.default_rng(27)
    inputs = {}
    for dt in DTYPES:
        inputs[f"{dt}_x"] = rng.standard_normal((P8 * M_ROWS, K_IN)).astype(np.float32)
        inputs[f"{dt}_w"] = rng.standard_normal((K_IN, N_OUT)).astype(np.float32)
        inputs[f"{dt}_g"] = rng.standard_normal((P8 * P8 * M_ROWS, N_OUT)).astype(np.float32)
    pod, data = GROUPS
    inputs["grp_x"] = rng.standard_normal((pod * data * M_ROWS, K_IN)).astype(np.float32)
    inputs["grp_w"] = rng.standard_normal((K_IN, N_OUT)).astype(np.float32)
    inputs["grp_g"] = rng.standard_normal((pod * data * data * M_ROWS, N_OUT)).astype(
        np.float32)
    inputs["ag"] = rng.standard_normal(P8 * AG_N).astype(np.float32)
    inputs["rs"] = rng.standard_normal((P8, P8 * RS_M)).astype(np.float32)
    inputs["g_ag"] = rng.standard_normal(P8 * P8 * AG_N).astype(np.float32)
    inputs["g_rs"] = rng.standard_normal(P8 * RS_M).astype(np.float32)
    body = f'''
import functools
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import collectives as C
from repro.kernels.collective_matmul import allgather_matmul_local

def vjp_agmm(mesh, axis, spec, x, w, g, n_dev, dt):
    local = functools.partial(allgather_matmul_local, axis=axis, use_pallas=False)
    fn = jax.jit(compat.shard_map(local, mesh=mesh, in_specs=(P(spec), P(spec)),
                                  out_specs=P(spec), check_vma=False))
    w_stacked = jnp.tile(jnp.asarray(w, dt), (n_dev, 1))
    _, vjp = jax.vjp(fn, jnp.asarray(x, dt), w_stacked)
    dx, dw = vjp(jnp.asarray(g, dt))
    dw = np.asarray(dw.astype(jnp.float32)).reshape(n_dev, *w.shape).sum(0)
    return np.asarray(dx.astype(jnp.float32)), dw

mesh = ref_mesh(({P8},), ("x",))
for dt in {DTYPES}:
    OUT[dt + "_dx"], OUT[dt + "_dw"] = vjp_agmm(mesh, "x", "x", IN[dt + "_x"], IN[dt + "_w"],
                                                IN[dt + "_g"], {P8}, dt)
gmesh = ref_mesh({GROUPS}, ("pod", "data"))
OUT["grp_dx"], OUT["grp_dw"] = vjp_agmm(gmesh, "data", ("pod", "data"), IN["grp_x"],
                                        IN["grp_w"], IN["grp_g"], {P8}, "float32")
fn = jax.jit(compat.shard_map(lambda a, r: C.concurrent_ag_rs_local(a, r[0], "x"),
                              mesh=mesh, in_specs=(P("x"), P("x")),
                              out_specs=(P("x"), P("x")), check_vma=False))
_, vjp = jax.vjp(fn, jnp.asarray(IN["ag"]), jnp.asarray(IN["rs"]))
d_ag, d_rs = vjp((jnp.asarray(IN["g_ag"]), jnp.asarray(IN["g_rs"])))
OUT["d_ag"], OUT["d_rs"] = np.asarray(d_ag), np.asarray(d_rs)
'''
    return inputs, run_reference(body, inputs)


# ------------------------------------------------ the allgather-matmul (#4)


def _grads(fn, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(x, w)
    assert y.requires_grad
    return torch.autograd.grad(y, (x, w), g)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("dt", DTYPES)
def test_allgather_matmul_backward_matches_jax_vjp(ref, dt, use_pallas):
    """dx and dw of make_allgather_matmul on an 8-rank stacked mesh against
    jax.vjp of the reference's jnp.dot branch (its Pallas branch has no
    vjp), within 1e-3 in f32 and 0.5 in bf16; no kernel launches for CPU
    tensors."""
    inputs, out = ref
    x = torch.from_numpy(inputs[f"{dt}_x"]).to(TORCH[dt]).reshape(P8, M_ROWS, K_IN)
    w = torch.from_numpy(inputs[f"{dt}_w"]).to(TORCH[dt])
    g = torch.from_numpy(inputs[f"{dt}_g"]).to(TORCH[dt]).reshape(P8, P8 * M_ROWS, N_OUT)
    fn = M.make_allgather_matmul(StackedMesh(x=P8), "x", use_pallas=use_pallas)
    before = _launches()
    dx, dw = _grads(fn, x, w, g)
    assert _launches() == before       # CPU tensors take the plain versions
    assert dx.dtype == dw.dtype == TORCH[dt]
    np.testing.assert_allclose(dx.float().numpy().reshape(P8 * M_ROWS, K_IN), out[f"{dt}_dx"],
                               atol=TOL[dt], rtol=0)
    np.testing.assert_allclose(dw.float().numpy(), out[f"{dt}_dw"], atol=TOL[dt], rtol=0)


def test_allgather_matmul_backward_two_groups_matches_jax_vjp(ref):
    """On (pod=2, data=4) each pod gathers over ``data``: dx per pod, and
    dw summed over both pods' ranks, against the reference's vjp."""
    inputs, out = ref
    pod, data = GROUPS
    x = torch.from_numpy(inputs["grp_x"]).reshape(pod * data, M_ROWS, K_IN)
    w = torch.from_numpy(inputs["grp_w"])
    g = torch.from_numpy(inputs["grp_g"]).reshape(pod * data, data * M_ROWS, N_OUT)
    fn = M.make_allgather_matmul(StackedMesh(pod=pod, data=data, model=1), "data")
    dx, dw = _grads(fn, x, w, g)
    np.testing.assert_allclose(dx.numpy().reshape(-1, K_IN), out["grp_dx"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(dw.numpy(), out["grp_dw"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("p,m,k,n", [(2, 3, 5, 7), (3, 8, 33, 16), (5, 2, 16, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allgather_matmul_backward_is_the_plain_backward(p, m, k, n, dtype):
    """Odd ranks, rows and widths: the backward equals the transposes it is
    made of, bitwise: dx the ring gather's backward of the per-rank
    products g_d w^T, dw the sum over ranks of X^T g_d; the two branches
    give the same bits, since both sum each product in f32."""
    gen = torch.Generator().manual_seed(p * m + k)
    x = torch.randn(p, m, k, generator=gen).to(dtype)
    w = torch.randn(k, n, generator=gen).to(dtype)
    g = torch.randn(p, p * m, n, generator=gen).to(dtype)
    rows = x.reshape(p * m, k)
    contrib = M.matmul_plain(g, w.t().expand(p, n, k))
    want_dx = C._transposed(contrib.reshape(p, p * m * k), C._ring_schedule(p)).view(p, m, k)
    want_dw = M.matmul_plain(rows.t().expand(p, k, p * m), g).sum(0)
    for use_pallas in (True, False):
        fn = lambda a, b: M.allgather_matmul_local(a, b, use_pallas=use_pallas,  # noqa: E731
                                                   bm=1, bk=1, bn=1)
        dx, dw = _grads(fn, x, w, g)
        assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw), use_pallas


def test_allgather_matmul_backward_of_one_input():
    """Only x, or only w, requires grad: the other's product is skipped."""
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 2, 8, generator=gen), torch.randn(8, 3, generator=gen)
    g = torch.randn(4, 8, 3, generator=gen)
    dx_both, dw_both = _grads(M.allgather_matmul_local, x, w, g)
    xr = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(M.allgather_matmul_local(xr, w), xr, g)
    wr = w.clone().requires_grad_()
    (dw,) = torch.autograd.grad(M.allgather_matmul_local(x, wr), wr, g)
    assert torch.equal(dx, dx_both) and torch.equal(dw, dw_both)


# ------------------------------------------------------ concurrent AG / RS


def test_concurrent_ag_rs_backward_matches_jax_vjp(ref):
    """Both gradients of concurrent AG/RS against jax.vjp of the
    reference's, bitwise in f32 (the gather's transpose sums each shard in
    JAX's nesting; the reduce-scatter's transpose only copies)."""
    inputs, out = ref
    ag = torch.from_numpy(inputs["ag"]).reshape(P8, AG_N).requires_grad_()
    rs = torch.from_numpy(inputs["rs"]).requires_grad_()
    g_ag = torch.from_numpy(inputs["g_ag"]).reshape(P8, P8 * AG_N)
    g_rs = torch.from_numpy(inputs["g_rs"]).reshape(P8, RS_M)
    before = _launches()
    got_ag, got_rs = C.concurrent_ag_rs_local(ag, rs)
    d_ag, d_rs = torch.autograd.grad((got_ag, got_rs), (ag, rs), (g_ag, g_rs))
    assert _launches() == before
    np.testing.assert_array_equal(d_ag.numpy().reshape(-1), out["d_ag"])
    np.testing.assert_array_equal(d_rs.numpy(), out["d_rs"])


@pytest.mark.parametrize("overlap", [False, True])
def test_concurrent_ag_rs_backward_is_the_separate_backwards(overlap, monkeypatch):
    """The backward equals, bitwise, those of ``ring_allgather_local(ag)``
    and ``ring_reduce_scatter_local(rs, direction=-1)``: its body is the
    forward's pair on the swapped cotangents, one ``ring_allgather`` and one
    ``ring_allgather_transpose`` of the ring schedule, on both stream paths
    (a CPU tensor has no side stream, so the two-stream path runs the same
    calls in the same order)."""
    gen = torch.Generator().manual_seed(3)
    p, n, m = 5, 7, 3
    ag = torch.randn(2, p, n, generator=gen).requires_grad_()
    rs = torch.randn(2, p, p * m, generator=gen).requires_grad_()
    g_ag, g_rs = torch.randn(2, p, p * n, generator=gen), torch.randn(2, p, m, generator=gen)
    want = torch.autograd.grad((C.ring_allgather_local(ag),
                                C.ring_reduce_scatter_local(rs, direction=-1)),
                               (ag, rs), (g_ag, g_rs))
    calls = []
    gather, transpose = C.ring_allgather, C.ring_allgather_transpose
    monkeypatch.setattr(C, "ring_allgather",
                        lambda x, schedule, out=None: calls.append(("gather", schedule))
                        or gather(x, schedule, out))
    monkeypatch.setattr(C, "ring_allgather_transpose",
                        lambda g, schedule: calls.append(("transpose", schedule))
                        or transpose(g, schedule))
    d_rs, d_ag = C._concurrent_ag_rs(g_rs, g_ag, overlap=overlap)   # the backward's body
    assert calls == [("gather", C._ring_schedule(p)), ("transpose", C._ring_schedule(p))]
    assert torch.equal(d_ag, want[0]) and torch.equal(d_rs, want[1])
    calls.clear()
    d_ag, d_rs = torch.autograd.grad(C.concurrent_ag_rs_local(ag, rs), (ag, rs), (g_ag, g_rs))
    assert torch.equal(d_ag, want[0]) and torch.equal(d_rs, want[1])
    assert [kind for kind, _ in calls] == ["gather", "transpose"] * 2   # forward, backward


@pytest.mark.parametrize("mode,direction", [("ring", 1), ("ring", -1), ("bidi", None)])
def test_reduce_scatter_backward_is_the_gather(mode, direction):
    """The ring reduce-scatters' backward is the gather they transpose (its
    direction the reduce-scatter's negated): pure copies, bitwise."""
    gen = torch.Generator().manual_seed(1)
    p, n = 4, 6
    x = torch.randn(p, p * n, generator=gen).requires_grad_()
    g = torch.randn(p, n, generator=gen)
    if mode == "ring":
        y = C.ring_reduce_scatter_local(x, direction=direction)
        want = C.ring_allgather_local(g, direction=-direction)
    else:
        y = C.bidi_ring_reduce_scatter_local(x)
        want = C._flat(C.ring_allgather(g, C._bidi_schedule(p, n, direction=-1)))
    (got,) = torch.autograd.grad(y, x, g)
    assert torch.equal(got, want)
    assert torch.equal(got, g.reshape(1, p * n).expand(p, p * n))

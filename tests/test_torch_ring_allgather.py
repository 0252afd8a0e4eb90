"""Ring kernel module and the stacked allgathers of the PyTorch port, held
against the JAX package: the ring schedule, the one-launch gather's plain
version step by step, the collectives' outputs (bitwise), the hierarchical
FSDP gather, and rank independence."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.kernels.ring_allgather import ring_schedule as ref_ring_schedule
from repro_torch import bridge
from repro_torch.configs import CollectiveConfig, MeshConfig
from repro_torch.core import collectives as C
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_slice
from repro_torch.runtime.serve_loop import make_prefill_step
from repro_torch.sharding.ctx import use_ctx
from repro_torch.sharding.fsdp import gather_leaf, make_param_gather, split_global
from test_torch_support import SMALL, flatten, random_tree, run_reference, serve_run

P8 = 8


@pytest.mark.parametrize("p", range(2, 10))
def test_ring_schedule_matches_reference(p):
    assert K.ring_schedule(p) == ref_ring_schedule(p)


def _id_buffer(p: int, n: int) -> torch.Tensor:
    """(P, P, n) f32 with shard j of rank j holding j + 1, zeros elsewhere."""
    buf = torch.zeros(p, p, n)
    for j in range(p):
        buf[j, j] = j + 1
    return buf


def _id_shards(p: int, n: int) -> torch.Tensor:
    """(P, n) f32, rank j's shard holding j + 1."""
    return torch.arange(1, p + 1, dtype=torch.float32)[:, None].expand(p, n).contiguous()


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_plain_ring_step_delivers_every_shard_once(p):
    """Driven through P - 1 steps, the plain ring step moves exactly the
    triples of ``ring_schedule``: each (receiver, shard) once."""
    buf = _id_buffer(p, 5)
    delivered = set()
    for s, trip in enumerate(K.ring_schedule(p)):
        before = buf.clone()
        K.ring_step_plain(buf, s)
        changed = {(int(r), int(j)) for r, j in
                   torch.nonzero((buf != before).any(-1)).tolist()}
        assert changed == {(rcv, shard) for _, rcv, shard in trip}
        assert not changed & delivered
        delivered |= changed
    want = torch.arange(1, p + 1, dtype=torch.float32)[None, :, None].expand(p, p, 5)
    assert torch.equal(buf, want)


def _schedule(mode: str, p: int, n: int, chains: int | None) -> tuple:
    return {"ring": lambda: C._ring_schedule(p), "ring-": lambda: C._ring_schedule(p, -1),
            "bidi": lambda: C._bidi_schedule(p, n),
            "bcast": lambda: C._bcast_schedule(p, chains)}[mode]()


def _delivered(p: int, mode: str, chains: int | None, k: int) -> set:
    """(receiver, shard) pairs that the reference's ``ring_schedule``
    delivers in the first k entries of the mode's schedule: the ring's
    steps in order (mirrored, rank r -> -r, along -1), and for the
    broadcasts round r's steps moving only the shards with shard % R == r."""
    ref = ref_ring_schedule(p)
    if mode == "ring-":
        ref = [[(-d % p, -r % p, -j % p) for d, r, j in trip] for trip in ref]
    rounds = p // chains if mode == "bcast" else 1
    out = set()
    for i in range(k):
        r, s = divmod(i, p - 1)
        out |= {(rcv, j) for _, rcv, j in ref[s] if j % rounds == r}
    return out


PREFIX_CASES = ([("ring", p, None) for p in (2, 3, 5, 8)]
                + [("ring-", p, None) for p in (2, 3, 5, 8)]
                + [("bidi", p, None) for p in (2, 3, 5, 8)]
                + [("bcast", 8, m) for m in (1, 2, 4)])


@pytest.mark.parametrize("mode,p,chains", PREFIX_CASES)
def test_every_prefix_fills_the_reference_slots(mode, p, chains):
    """After the first k entries of a gather's schedule, for every k, the
    plain one-launch gather has filled exactly the slots that the JAX
    package's ``ring_schedule`` delivers by then (bidi: the first half of
    each slot along +1, the second half on the mirrored ring), each with
    its shard, and left every other slot of ``out`` as it was (k = 0: the
    shards installed on the diagonal). A copy of every shard out of the
    diagonal at once fails at k = 1."""
    n = 6
    sched = _schedule(mode, p, n, chains)
    assert len(sched) == (p - 1) * (p // chains if chains else 1)
    for k in range(len(sched) + 1):
        buf = torch.zeros(p, p, n)
        got = K.ring_allgather_plain(_id_shards(p, n), sched[:k], out=buf)
        assert got is buf
        halves = ((0, n // 2, "ring"), (n // 2, n, "ring-")) if mode == "bidi" else \
            ((0, n, mode),)
        for lo, hi, half in halves:
            want = {(j, j) for j in range(p)} | _delivered(p, half, chains, k)
            filled = {(r, j) for r, j in torch.nonzero(got[..., lo:hi].any(-1)).tolist()}
            assert filled == want, (k, lo)
            for r, j in filled:
                assert torch.equal(got[r, j, lo:hi], torch.full((hi - lo,), j + 1.0))


def _counters() -> tuple:
    return K.launches, K.allgather_launches, dict(K.entries)


@pytest.mark.parametrize("one_launch", [False, True])
def test_ring_step_on_cpu_counts_no_launch(one_launch):
    """On a CPU tensor neither ``ring_step`` nor ``ring_allgather`` counts a
    launch or a schedule entry; both run the plain steps."""
    before = _counters()
    buf = _id_buffer(4, 3)
    if one_launch:
        buf = K.ring_allgather(_id_shards(4, 3), C._ring_schedule(4))
    else:
        for s in range(3):
            K.ring_step(buf, s)
    assert _counters() == before
    assert torch.equal(buf, _id_buffer(4, 3).sum(0, keepdim=True).expand(4, 4, 3))


@pytest.mark.parametrize("one_launch", [False, True])
@pytest.mark.parametrize("bad", [
    dict(buf=torch.zeros(4, 4, 3, dtype=torch.int32), step=0),
    dict(buf=torch.zeros(4, 3, 3), step=0),
    dict(buf=torch.zeros(4, 4, 6)[..., ::2], step=0),
    dict(buf=torch.zeros(4, 4, 3), step=3),
    dict(buf=torch.zeros(4, 4, 3), step=0, direction=2),
    dict(buf=torch.zeros(4, 4, 3), step=0, rounds=3),
    dict(buf=torch.zeros(4, 4, 3), step=0, rounds=2, active_round=2),
    dict(buf=torch.zeros(4, 4, 3), step=0, split=4),
    dict(buf=torch.zeros(4, 4, 3), step=0, split=-1),
])
def test_ring_step_rejects_what_the_kernel_does_not_take(bad, one_launch):
    """Both wrappers refuse the dtype, a non-square or non-contiguous buffer,
    a step, direction or round mask outside the ring, and a split outside
    0..n. ``ring_allgather`` refuses them given the buffer as ``out`` (a
    non-square one is not the shards' buffer), and so do the checks its
    kernel path makes (the buffer's, then the schedule's, cached per
    schedule)."""
    if not one_launch:
        with pytest.raises((TypeError, ValueError)):
            K.ring_step(**bad)
        return
    bad = dict(bad)
    buf = bad.pop("buf")
    entry = (bad.pop("step"), bad.get("direction", 1), bad.get("split"),
             bad.get("rounds", 1), bad.get("active_round", 0))
    x = torch.zeros(buf.shape[0], buf.shape[-1], dtype=buf.dtype)
    with pytest.raises((TypeError, ValueError)):
        K.ring_allgather(x, (entry,), out=buf)
    with pytest.raises((TypeError, ValueError)):
        p, n = K._check_buf(buf)
        K._packed((entry,), p, n)


def _every_entry(p: int, n: int):
    """Every entry a ring step takes at P = p over slots of n: each step,
    direction, split (None, 0, inside, n) and round mask."""
    for step in range(p - 1):
        for direction in (1, -1):
            for split in (None, 0, 1, n // 2, n):
                for rounds in (r for r in range(1, p + 1) if p % r == 0):
                    for active in range(rounds):
                        yield step, direction, split, rounds, active


@pytest.mark.parametrize("p", [2, 3, 4, 5, 8])
def test_one_entry_gather_without_install_is_the_ring_step(p):
    """``ring_step`` on the card is one launch of the gather's kernel with
    its entry as ``_packed`` passes it and no shards. That launch's plain
    version, ``ring_allgather_plain(None, (entry,), out=buf)``, equals
    ``ring_step_plain`` on a random buffer (one and two groups) on every
    (step, direction, split, rounds, active_round) case, in place; the
    packed entry carries the split resolved (n for None), and replaying it
    gives the same step."""
    n = 6
    rng = np.random.default_rng(p)
    for groups in (1, 2):
        buf = torch.from_numpy(rng.standard_normal((groups, p, p, n)).astype(np.float32))
        for entry in _every_entry(p, n):
            step, direction, split, rounds, active = entry
            want = K.ring_step_plain(buf.clone(), step, direction=direction, split=split,
                                     rounds=rounds, active_round=active)
            out = buf.clone()
            assert K.ring_allgather_plain(None, (entry,), out=out) is out
            assert torch.equal(out, want), entry
            ((packed, count),), kinds = K._packed((entry,), p, n)
            resolved = (step, direction, n if split is None else split, rounds, active)
            assert count == 1 and tuple(packed) == resolved and sum(dict(kinds).values()) == 1
            again = K.ring_step_plain(buf.clone(), resolved[0], direction=resolved[1],
                                      split=resolved[2], rounds=resolved[3],
                                      active_round=resolved[4])
            assert torch.equal(again, want), entry
    with pytest.raises(ValueError, match="needs out"):
        K.ring_allgather_plain(None, ((0, 1, None, 1, 0),))


@pytest.mark.parametrize("p,chains,counts", [(1, 1, (0,)), (8, 4, (14,)), (8, 1, (56,)),
                                             (16, 1, (128, 112)), (24, 2, (128, 128, 20))])
def test_ring_allgather_splits_a_long_schedule_into_launches(p, chains, counts):
    """A launch's parameters carry at most 128 schedule entries: a longer
    schedule (bcast at P = 16 with one chain has 240) goes as one launch per
    128 entries, in order, and an empty one (P = 1) as one launch that only
    installs the shards. On the CPU the whole schedule gathers every shard
    to every rank."""
    n = 5
    sched = C._bcast_schedule(p, chains)
    chunks, kinds = K._packed(sched, p, n)
    assert tuple(count for _, count in chunks) == counts
    flat = [v for packed, count in chunks for v in packed[:5 * count]]
    assert flat == [v for e in sched for v in (e[0], e[1], n, e[3], e[4])]
    assert dict(kinds) == ({"bcast": len(sched)} if p // chains > 1 else
                           {"ring": len(sched)} if sched else {})
    x = torch.from_numpy(np.random.default_rng(p).standard_normal((p, n)).astype(np.float32))
    assert torch.equal(C._flat(K.ring_allgather(x, sched)), C.plain_allgather_local(x))


# ------------------------------------------------ collectives vs the reference

CASES = [("ring", None), ("bidi", None), ("bcast", 1), ("bcast", 2), ("bcast", 4),
         ("bcast", 8)]
SIZES = [6, 7]


@pytest.fixture(scope="module")
def ref_collectives():
    rng = np.random.default_rng(0)
    inputs = {f"x{n}": rng.standard_normal(P8 * n).astype(np.float32) for n in SIZES}
    body = f'''
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import collectives as C
mesh = ref_mesh(({P8},), ("x",))
for n in {SIZES}:
    x = jax.device_put(IN[f"x{{n}}"], NamedSharding(mesh, P("x")))
    for mode, chains in {CASES}:
        out = C.make_allgather(mesh, "x", mode, n_chains=chains)(x)
        OUT[f"{{mode}}{{chains}}_{{n}}"] = np.asarray(out)
'''
    return inputs, run_reference(body, inputs)


@pytest.mark.parametrize("via", ["make_allgather", "ring_allgather_plain"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,chains", CASES)
def test_stacked_allgather_matches_jax(ref_collectives, mode, chains, n, via):
    """Every rank's gathered copy equals JAX's make_allgather, bitwise:
    through the port's entry point, and as ``ring_allgather_plain`` over
    the mode's whole schedule on the ring buffer."""
    inputs, ref = ref_collectives
    mesh = StackedMesh(x=P8)
    x = torch.from_numpy(inputs[f"x{n}"]).reshape(P8, n)
    if via == "make_allgather":
        got = C.make_allgather(mesh, "x", mode, n_chains=chains)(x)
    else:
        sched = _schedule(mode, P8, n, chains)
        got = C._flat(K.ring_allgather_plain(x, sched))
    want = ref[f"{mode}{chains}_{n}"]
    assert got.shape == (P8, P8 * n)
    for r in range(P8):
        np.testing.assert_array_equal(got[r].numpy(), want)
    plain = C.make_allgather(mesh, "x", "xla")(x)
    assert torch.equal(plain, got)


@pytest.fixture(scope="module")
def ref_hier_gather():
    tree = random_tree(SMALL, 3)
    inputs = {k: v for k, v in flatten(tree).items() if k.startswith("blocks/")}
    body = '''
from jax.sharding import NamedSharding
from repro.configs.base import CollectiveConfig, MeshConfig
from repro.sharding.fsdp import make_param_gather
from repro.sharding.specs import param_pspecs
mesh = ref_mesh((2, 4, 1), ("pod", "data", "model"))
mcfg = MeshConfig(multi_pod=True)
blocks = unflatten(IN, "blocks/")
layer = jax.tree.map(lambda a: a[1], blocks)
specs = param_pspecs(layer, mesh, mcfg)
layer = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), layer, specs)
for mode in ("mcast", "mcast_ring", "mcast_bcast"):
    gather = make_param_gather(mesh, mcfg, CollectiveConfig(fsdp_mode=mode, n_chains=2))
    out = jax.jit(gather)(layer)
    for path, leaf in jax.tree_util.tree_flatten_with_path(out)[0]:
        OUT[mode + "/" + "/".join(k.key for k in path)] = np.asarray(leaf)
'''
    return tree, run_reference(body, inputs)


@pytest.mark.parametrize("mode", ["mcast", "mcast_ring", "mcast_bcast"])
def test_hierarchical_param_gather_matches_jax(ref_hier_gather, mode):
    """On a (pod=2, data=4) mesh the per-layer gather (data ring, then the
    pod axis by broadcast chains) gives every rank the reference's layer."""
    tree, ref = ref_hier_gather
    mesh, mcfg = StackedMesh(pod=2, data=4, model=1), MeshConfig(multi_pod=True)
    params = bridge.to_torch(tree, mesh, mcfg, dtype=torch.float32, device="cpu")
    gather = make_param_gather(mesh, mcfg, CollectiveConfig(fsdp_mode=mode, n_chains=2))
    got = flatten(gather(layer_slice(params["blocks"], 1)))
    for key, leaf in got.items():
        want = ref[f"{mode}/{key}"]
        for r in range(mesh.n_ranks):
            np.testing.assert_array_equal(leaf[r].numpy(), want, err_msg=key)


@pytest.mark.parametrize("mode", ["xla", "bidi", "ring", "bcast"])
def test_gather_leaf_odd_flat_length(mode):
    """An odd flat shard takes the plain ring in bidi mode, as the reference's
    _ag_local does; every mode still reassembles the leaf."""
    mesh = StackedMesh(data=4, model=1)
    a = np.arange(4 * 3 * 5, dtype=np.float32).reshape(12, 5)
    local = torch.from_numpy(a).reshape(4, 3, 5)
    full = gather_leaf(local, (("data",), None), mesh, ("data",), mode, 2)
    for r in range(4):
        np.testing.assert_array_equal(full[r].numpy(), a)


def test_corrupt_rank_copy_changes_only_that_rank():
    """A wrong byte in rank r's gathered copy of a layer changes rank r's
    batch rows and no others: each rank computes with its own copy."""
    mesh, bad_rank = StackedMesh(data=P8, model=1), 5
    params = bridge.to_torch(random_tree(SMALL, 0), mesh, MeshConfig(),
                             dtype=torch.float32, device="cpu")
    run = serve_run(SMALL, "mcast", 16, 12)
    _, ctx, prefill = make_prefill_step(run, mesh, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, SMALL.vocab_size, (16, 12)))
    clean, _ = prefill(params, {"tokens": tokens})

    paper = make_param_gather(mesh, MeshConfig(), run.collective)

    def corrupting(tree):
        out = paper(tree)
        out["attn"]["wq"][bad_rank, 0, 0] += 1.0
        return out

    api = build_model(SMALL, device="cpu")
    with use_ctx(dataclasses.replace(ctx, gather_params=corrupting)):
        dirty, _ = api.prefill_fn(params, {"tokens": tokens})
    rows = tokens.shape[0] // P8
    for r in range(P8):
        same = torch.equal(clean[r * rows:(r + 1) * rows], dirty[r * rows:(r + 1) * rows])
        assert same == (r != bad_rank), r


def test_make_param_gather_xla_is_plain_gather():
    mesh = StackedMesh(data=P8, model=1)
    params = bridge.to_torch(random_tree(SMALL, 0), mesh, MeshConfig(),
                             dtype=torch.float32, device="cpu")
    layer = layer_slice(params["blocks"], 0)
    before = K.launches
    outs = {m: flatten(make_param_gather(mesh, MeshConfig(),
                                         CollectiveConfig(fsdp_mode=m))(layer))
            for m in ("xla", "mcast", "mcast_ring", "mcast_bcast")}
    assert K.launches == before
    for m, got in outs.items():
        for key, leaf in got.items():
            assert torch.equal(leaf, outs["xla"][key]), (m, key)


# ------------------------------------------- the gathers' backward and the RS

GRAD_CASES = [("ring", None), ("bidi", None), ("bcast", 2)]
RS_CASES = [("ring", 1), ("ring", -1), ("bidi", None)]


@pytest.fixture(scope="module")
def ref_transposes():
    """jax.vjp of the reference's gathers under a shard_map whose out_specs
    is P('x'), so that each device's gathered copy is its own output with
    its own cotangent; and the reference's ring reduce-scatters, each device
    with its own contribution."""
    rng = np.random.default_rng(5)
    inputs = {}
    for n in SIZES:
        inputs[f"x{n}"] = rng.standard_normal(P8 * n).astype(np.float32)
        inputs[f"g{n}"] = rng.standard_normal(P8 * P8 * n).astype(np.float32)
    body = f'''
import functools
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import collectives as C
mesh = ref_mesh(({P8},), ("x",))
gathers = {{"ring": functools.partial(C.ring_allgather_local, axis="x"),
           "bidi": functools.partial(C.bidi_ring_allgather_local, axis="x"),
           "bcast": functools.partial(C.bcast_allgather_local, axis="x", n_chains=2)}}
scatters = {{"ring1": functools.partial(C.ring_reduce_scatter_local, axis="x", direction=1),
            "ring-1": functools.partial(C.ring_reduce_scatter_local, axis="x", direction=-1),
            "bidiNone": functools.partial(C.bidi_ring_reduce_scatter_local, axis="x")}}
def per_device(fn):
    return jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                                    check_vma=False))
for n in {SIZES}:
    for name, fn in gathers.items():
        _, vjp = jax.vjp(per_device(fn), IN[f"x{{n}}"])
        OUT[f"{{name}}_{{n}}"] = np.asarray(vjp(IN[f"g{{n}}"])[0])
    for name, fn in scatters.items():
        OUT[f"rs_{{name}}_{{n}}"] = np.asarray(per_device(fn)(IN[f"g{{n}}"]))
'''
    return inputs, run_reference(body, inputs)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,chains", GRAD_CASES)
def test_gather_backward_matches_jax_vjp(ref_transposes, mode, chains, n):
    """The stacked gather's backward (the transposed ring steps in reverse
    order) against JAX's transpose of the same ring, for a random cotangent
    per rank's copy. It sums each shard along its chain in JAX's nesting,
    and the results are bitwise equal in f32."""
    inputs, ref = ref_transposes
    mesh = StackedMesh(x=P8)
    x = torch.from_numpy(inputs[f"x{n}"]).reshape(P8, n).requires_grad_()
    g = torch.from_numpy(inputs[f"g{n}"]).reshape(P8, P8 * n)
    y = C.make_allgather(mesh, "x", mode, n_chains=chains)(x)
    (got,) = torch.autograd.grad(y, x, g)
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref[f"{mode}_{n}"])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode,direction", RS_CASES)
def test_reduce_scatter_matches_jax(ref_transposes, mode, direction, n):
    """The port's ring reduce-scatters (transposed ring steps, no new
    kernel) against the reference's, each rank with its own contribution:
    the same sums in the same order, bitwise equal in f32."""
    inputs, ref = ref_transposes
    mesh = StackedMesh(x=P8)
    contrib = torch.from_numpy(inputs[f"g{n}"]).reshape(P8, P8 * n)
    if mode == "ring":
        got = C.over_axis(contrib, mesh, "x",
                          lambda c: C.ring_reduce_scatter_local(c, direction=direction))
    else:
        got = C.make_reduce_scatter(mesh, "x", mode)(contrib)
    assert got.shape == (P8, n)
    np.testing.assert_array_equal(got.numpy().reshape(-1), ref[f"rs_{mode}{direction}_{n}"])
    want = contrib.reshape(P8, P8, n).sum(0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("kw", [dict(), dict(direction=-1), dict(split=3),
                                dict(direction=-1, split=0), dict(rounds=2, active_round=1)])
def test_transposed_step_is_the_adjoint(p, kw):
    """<step(a), b> == <a, step^T(b)> for every step. The forward overwrites
    the receivers' slots, so the exact adjoint zeroes their cotangent; the
    transposed step leaves it in place, as no later (reverse-order) step
    reads it and only the diagonal is read at the end."""
    if p % kw.get("rounds", 1):
        kw = dict(rounds=p, active_round=1)  # P = 3: three one-chain rounds
    gen = torch.Generator().manual_seed(p)
    for s in range(p - 1):
        a = torch.randn(2, p, p, 5, generator=gen)
        b = torch.randn(2, p, p, 5, generator=gen)
        fwd = K.ring_step_plain(a.clone(), s, **kw)
        received = fwd != a
        bt = K.ring_step_transpose_plain(b.clone(), s, **kw)
        torch.testing.assert_close((fwd * b).sum(), (a * bt.masked_fill(received, 0)).sum())
        assert torch.equal(bt[received], b[received])


def test_transposed_step_on_cpu_counts_no_launch():
    """The plain transposed steps in reverse order sum all four ranks' ones
    on every diagonal slot; the one-launch transpose on the same CPU tensor
    gives that diagonal and counts no launch."""
    before = K.allgather_transpose_launches
    buf = torch.ones(4, 4, 3)
    for s in reversed(range(3)):
        K.ring_step_transpose_plain(buf, s)
    assert torch.equal(buf.diagonal(dim1=0, dim2=1), torch.full((3, 4), 4.0))
    got = K.ring_allgather_transpose(torch.ones(4, 4, 3), C._ring_schedule(4))
    assert K.allgather_transpose_launches == before
    assert torch.equal(got, buf.diagonal(dim1=0, dim2=1).T)


@pytest.mark.parametrize("bad", [
    dict(buf=torch.zeros(4, 4, 3, dtype=torch.int32), step=0),
    dict(buf=torch.zeros(4, 3, 3), step=0),
    dict(buf=torch.zeros(4, 4, 3), step=3),
    dict(buf=torch.zeros(4, 4, 3), step=0, rounds=3),
])
def test_transposed_step_rejects_what_the_kernel_does_not_take(bad):
    """The plain transposed step refuses the dtype, the shape, the step and
    the round mask that the one-launch transpose refuses for the same
    entry."""
    with pytest.raises((TypeError, ValueError)):
        K.ring_step_transpose_plain(**bad)
    entry = (bad["step"], 1, None, bad.get("rounds", 1), 0)
    with pytest.raises((TypeError, ValueError)):
        K.ring_allgather_transpose(bad["buf"], (entry,))


@pytest.mark.parametrize("mode", ["xla", "bidi", "ring", "bcast"])
def test_hierarchical_gather_backward_sums_over_ranks(mode):
    """Through gather_leaf on a (pod=2, data=4) mesh, each shard's gradient
    is the sum over all 8 ranks of the cotangent of its piece."""
    mesh = StackedMesh(pod=2, data=4, model=1)
    spec = ((("pod", "data")), None)
    a = torch.randn(16, 6)
    x = split_global(a, spec, mesh.n_ranks).requires_grad_()
    g = torch.randn(8, 16, 6)
    y = gather_leaf(x, spec, mesh, ("pod", "data"), mode, 2)
    for r in range(8):
        assert torch.equal(y[r].detach(), a)
    (got,) = torch.autograd.grad(y, x, g)
    want = split_global(g.sum(0), spec, mesh.n_ranks)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# -------------------------------------- the gather's transpose in one call


def _mixed_schedule(n: int) -> tuple:
    """Entries of every kind in no schedule's order, at P = 8: whole slots,
    splits at 0, inside and at n, both directions, round masks."""
    return ((0, 1, None, 1, 0), (1, 1, n // 3, 1, 0), (2, -1, 0, 1, 0), (0, -1, n, 2, 1),
            (3, 1, n // 2, 4, 3), (6, -1, min(1, n), 1, 0), (5, 1, n, 8, 5))


TRANSPOSE_CASES = ([(mode, p, None) for mode in ("ring", "ring-", "bidi") for p in (2, 3, 5, 8)]
                   + [("bcast", 8, m) for m in (1, 2, 4)] + [("mixed", 8, None)]
                   + [("bcast", 16, 1)])   # 240 entries


def _transpose_schedule(mode: str, p: int, n: int, chains: int | None) -> tuple:
    return _mixed_schedule(n) if mode == "mixed" else _schedule(mode, p, n, chains)


def _replayed(g: torch.Tensor, sched: tuple) -> torch.Tensor:
    """``ring_step_transpose_plain`` over the entries in reverse order on a
    copy of g, then the diagonal: rank d's slot d."""
    buf = g.clone(memory_format=torch.contiguous_format)
    for step, direction, split, rounds, active in reversed(sched):
        K.ring_step_transpose_plain(buf, step, direction=direction, split=split, rounds=rounds,
                                    active_round=active)
    return buf.diagonal(dim1=-3, dim2=-2).transpose(-1, -2)


def _cotangent(p: int, n: int, dtype, layout: str) -> torch.Tensor:
    """A cotangent (..., P, P, n) from a seed: one group, contiguous; two
    groups as a transposed view; or two groups expanded from one (the
    stride-0 gradient autograd passes for a broadcast)."""
    rng = np.random.default_rng(p * 100 + n)
    base = torch.from_numpy(rng.standard_normal((2, p, n, p)).astype(np.float32)).to(dtype)
    if layout == "one":
        return base[0].transpose(-1, -2).contiguous()
    if layout == "transposed":
        return base.transpose(-1, -2)
    return base[:1].transpose(-1, -2).expand(2, p, p, n)


@pytest.mark.parametrize("dtype,layout", [(torch.float32, "one"),
                                          (torch.bfloat16, "transposed"),
                                          (torch.float16, "expanded")])
@pytest.mark.parametrize("mode,p,chains", TRANSPOSE_CASES)
def test_allgather_transpose_equals_reversed_steps(mode, p, chains, dtype, layout):
    """On every prefix of the ring (both directions), bidi, broadcast (M =
    1, 2, 4; 240 entries at P = 16) and mixed schedules, k = 0 included,
    ``ring_allgather_transpose`` on a CPU tensor equals the reversed replay
    of the plain transposed steps, bitwise: f32, bf16 and f16, one and two
    groups, contiguous or not. The cotangent is left as it was."""
    n = 7
    sched = _transpose_schedule(mode, p, n, chains)
    g = _cotangent(p, n, dtype, layout)
    before = g.clone()
    for k in range(len(sched) + 1):
        got = K.ring_allgather_transpose(g, sched[:k])
        assert got.shape == (*g.shape[:-3], p, n) and got.dtype == dtype
        assert torch.equal(got, _replayed(g, sched[:k])), k
    assert torch.equal(g, before)


def _lanes(g: torch.Tensor, schedule: tuple) -> torch.Tensor:
    """A model of the reads-only launch, rank by rank: each entry's sum
    adds the rank's own slot, loaded from g, and its neighbour's slot,
    loaded from g or, where the entry continues the one before, the sum the
    neighbour made there; the diagonal's last sum, else g's diagonal."""
    p, n = g.shape[-2:]
    flat, _ = K._checked(schedule, p, n)
    flat.reverse()
    out = g.diagonal(dim1=-3, dim2=-2).transpose(-1, -2).clone()
    cuts = sorted({0, n, *(e[2] for e in flat)})
    for lo, hi in zip(cuts, cuts[1:]):
        held, prev = [None] * p, None
        for entry in flat:
            step, direction, split, rounds, active = entry
            dr = direction if lo < split else -direction
            chained = prev is not None and prev[0] == step + 1 and prev[1:] == entry[1:]
            sums = [None] * p
            for d in range(p):
                src = (d - dr * step) % p
                if src % rounds != active:
                    continue
                nb = held[(d + dr) % p] if chained else g[..., (d + dr) % p, src, lo:hi]
                sums[d] = g[..., d, src, lo:hi] + nb
                if src == d:
                    out[..., d, lo:hi] = sums[d]
            held, prev = sums, entry
    return out


@pytest.mark.parametrize("mode,p,chains", TRANSPOSE_CASES[:-1])
def test_reads_only_launches_are_exact(mode, p, chains):
    """Where ``_packed_transpose`` lets the kernel only read the cotangent
    (every prefix of the ring, bidi and broadcast schedules; the mixed one
    up to its first break), a model of that launch, lane by lane, equals
    the plain version bitwise (bf16, two groups); elsewhere the launches
    work in place on a copy, entry by entry, as the plain steps do."""
    n = 7
    sched = _transpose_schedule(mode, p, n, chains)
    g = _cotangent(p, n, torch.bfloat16, "transposed")
    for k in range(len(sched) + 1):
        _, _, in_place = K._packed_transpose(sched[:k], p, n)
        assert in_place == (mode == "mixed" and k > 1), k
        if not in_place:
            assert torch.equal(_lanes(g, sched[:k]), K.ring_allgather_transpose_plain(g, sched[:k]))


@pytest.mark.parametrize("p,chains,counts,in_place", [
    (1, 1, (0,), False), (8, 4, (14,), False), (8, 1, (56,), False),
    (16, 1, (128, 112), True), (24, 2, (128, 128, 20), True), (33, 33, (32,), True)])
def test_allgather_transpose_packs_the_schedule_reversed(p, chains, counts, in_place):
    """The transpose's launches carry the schedule's entries in reverse
    order, at most 128 each (one launch even for none: it reads the
    diagonal); more than one launch, or P > 32, works in place."""
    n = 5
    sched = C._bcast_schedule(p, chains)
    chunks, kinds, got_in_place = K._packed_transpose(sched, p, n)
    assert tuple(count for _, count in chunks) == counts and got_in_place == in_place
    flat = [v for packed, count in chunks for v in packed[:5 * count]]
    assert flat == [v for e in reversed(sched) for v in (e[0], e[1], n, e[3], e[4])]
    assert dict(kinds) == ({"bcast": len(sched)} if p // chains > 1 else
                           {"ring": len(sched)} if sched else {})


def test_allgather_transpose_on_cpu_counts_no_launch():
    """On a CPU tensor the one-call transpose counts no launch and no
    entry; every rank's gradient sums all four ranks' cotangents."""
    before = (K.allgather_transpose_launches, dict(K.transpose_entries))
    got = K.ring_allgather_transpose(torch.ones(4, 4, 3), C._ring_schedule(4))
    assert (K.allgather_transpose_launches, dict(K.transpose_entries)) == before
    assert torch.equal(got, torch.full((4, 3), 4.0))


@pytest.mark.parametrize("bad", [
    dict(buf=torch.zeros(4, 4, 3, dtype=torch.int32), step=0),
    dict(buf=torch.zeros(4, 3, 3), step=0),
    dict(buf=torch.zeros(4, 3), step=0),
    dict(buf=torch.zeros(4, 4, 3), step=3),
    dict(buf=torch.zeros(4, 4, 3), step=0, direction=2),
    dict(buf=torch.zeros(4, 4, 3), step=0, rounds=3),
    dict(buf=torch.zeros(4, 4, 3), step=0, rounds=2, active_round=2),
    dict(buf=torch.zeros(4, 4, 3), step=0, split=4),
    dict(buf=torch.zeros(4, 4, 3), step=0, split=-1),
])
def test_allgather_transpose_rejects_what_the_kernel_does_not_take(bad):
    """The one-call transpose refuses what ``ring_allgather`` refuses: the
    dtype, a cotangent that is not (..., P, P, n), and a step, direction,
    round mask or split outside the ring; so do the checks of its kernel
    path (the schedule's, cached per schedule)."""
    bad = dict(bad)
    buf = bad.pop("buf")
    entry = (bad.pop("step"), bad.get("direction", 1), bad.get("split"),
             bad.get("rounds", 1), bad.get("active_round", 0))
    with pytest.raises((TypeError, ValueError)):
        K.ring_allgather_transpose(buf, (entry,))
    if buf.dim() == 3 and buf.shape[0] == buf.shape[1] and buf.dtype == torch.float32:
        with pytest.raises(ValueError):
            K._packed_transpose((entry,), 4, 3)

"""The port's launch layer beyond the launchers: the (arch x shape) cell
grid, the collective byte counters (``launch/collective_stats.py``, the
counterpart of ``repro.launch.hlo_stats``) and the dry-run on the meta
device (``launch/dryrun.py``, the counterpart of ``repro.launch.dryrun``),
against the JAX package's.

One reference subprocess with fake CPU devices, started first (the port's
runs go on beside it), compiles four collectives under ``shard_map`` on 8
devices and reads their bytes with ``hlo_stats.collective_stats``, and runs
the reference's ``run_cell`` on smollm-135m's ``decode_32k`` (xla) and
``prefill_32k`` (mcast_ring) on an Auto ``(8, 1)`` mesh. The counters equal
hlo_stats's bytes exactly, kind by kind. ``run_cell``'s ``analytic`` is
the reference's field for field; its argument bytes are within 1 % of
XLA's, once the port's int64 token ids are counted at their 8 bytes
against the reference's int32; its collective bytes equal, exactly, what
the reference's own parameter shapes imply for the gathers the port runs
(every dp-sharded leaf once, the tied embedding twice: lookup and head).
The reference's HLO counts are not that oracle: XLA:CPU widens bf16
collectives to f32, and hlo_stats scales a ring scan nested in the layer
scan by the layer count alone; the test holds that explanation to the
reference's numbers too.
"""
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import iter_cells as ref_iter_cells
from repro.configs import make_run_config as ref_make_run_config
from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 cell_supported, get_model_config, get_shape, iter_cells,
                                 make_run_config)
from repro_torch.core import collectives as C
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels import collective_matmul as M
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch import collective_stats as CS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import attention
from repro_torch.runtime.train_loop import init_state, make_train_step
from test_torch_support import SMALL, SRC, one_torch_thread, run_reference  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MESH8 = StackedMesh(data=8, model=1)
N = 1024          # f32 elements of each rank's shard in the collectives' check
CHUNKS = 4        # the pipelined broadcast's chunks
ROWS = 3          # a rank's rows in the tp cases: over_axis's inner dims
CELLS = (("decode_32k", "xla"), ("prefill_32k", "mcast_ring"))

# ------------------------------------------------------------------ the cell grid


def test_cell_grid_matches_reference():
    """The 40 (arch, shape) cells, 32 runnable (long_500k for the two
    sub-quadratic architectures alone), entry for entry the reference's."""
    got = list(iter_cells(include_skipped=True))
    assert got == list(ref_iter_cells(include_skipped=True))
    assert len(got) == 40 and sum(c[2] for c in got) == 32
    assert list(iter_cells()) == [c for c in got if c[2]]
    for arch, shape, ok, why in got:
        assert cell_supported(get_model_config(arch), get_shape(shape)) == (ok, why)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_run_config_matches_reference(multi_pod):
    for arch, shape, _, _ in iter_cells():
        got = make_run_config(arch, shape, multi_pod=multi_pod, grad_accum=2, remat="dots")
        want = ref_make_run_config(arch, shape, multi_pod=multi_pod, grad_accum=2,
                                   remat="dots")
        assert got.model.name == want.model.name and got.model.num_layers == want.model.num_layers
        assert (got.shape.name, got.shape.kind, got.shape.seq_len, got.shape.global_batch) == (
            want.shape.name, want.shape.kind, want.shape.seq_len, want.shape.global_batch)
        assert got.mesh.shape == want.mesh.shape and got.mesh.axes == want.mesh.axes
        assert (got.train.grad_accum, got.train.remat) == (2, "dots")


# ----------------------------------------------------------------- reference

_BODY = f'''
import json
from repro.launch import dryrun, hlo_stats    # sets 512 host devices before the backend starts
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import collectives as RC

make_mesh = jax.make_mesh
jax.make_mesh = lambda shape, names, **kw: make_mesh(
    shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)

import jax.numpy as jnp
mesh = jax.make_mesh((8,), ("x",), devices=jax.devices()[:8])

def stats(fn, n_in, chain=()):
    f = jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=P("x"), out_specs=P("x")))
    arg = jax.ShapeDtypeStruct((n_in,), jnp.float32)
    st = hlo_stats.collective_stats(f.lower(arg).compile().as_text(), 8, loop_chain=chain)
    return st.as_dict()

mesh2 = jax.make_mesh((2, 4), ("d", "m"), devices=jax.devices()[:8])

def stats_tp(fn, cols):
    f = jax.jit(compat.shard_map(fn, mesh=mesh2, in_specs=P("d", "m"), out_specs=P("d", "m")))
    arg = jax.ShapeDtypeStruct((2 * {ROWS}, 4 * cols), jnp.float32)
    return hlo_stats.collective_stats(f.lower(arg).compile().as_text(), 8).as_dict()

cases = {{
    "tp-all-gather": stats_tp(lambda v: jax.lax.all_gather(v, "m", axis=1, tiled=True)[:, :{N}],
                              {N}),
    "tp-reduce-scatter": stats_tp(lambda v: jax.lax.psum_scatter(
        v, "m", scatter_dimension=1, tiled=True), 4 * {N}),
    "all-gather": stats(lambda v: jax.lax.all_gather(v, "x", tiled=True), 8 * {N}),
    "reduce-scatter": stats(lambda v: jax.lax.psum_scatter(v, "x", tiled=True), 64 * {N}),
    "all-reduce": stats(lambda v: jax.lax.psum(v, "x"), 8 * {N}),
    "collective-permute": stats(lambda v: jax.lax.ppermute(
        v, "x", [(i, (i + 1) % 8) for i in range(8)]), 8 * {N}),
    "broadcast": stats(lambda v: RC.pipelined_broadcast_local(v, "x", n_chunks={CHUNKS}),
                       8 * {N}, chain=({CHUNKS} + 6,)),
}}
for kind, st in cases.items():
    OUT["coll/" + kind + "/per_device_total"] = np.int64(st["per_device_total"])
    OUT["coll/" + kind + "/total_bytes"] = np.int64(st["total_bytes"])
    for k, v in st["per_device_bytes"].items():
        OUT["coll/" + kind + "/kind/" + k] = np.int64(v)

for shape, mode in {list(CELLS)}:
    rec = dryrun.run_cell("smollm-135m", shape, False, mesh_shape=(8, 1), fsdp_mode=mode)
    assert rec["ok"], rec.get("traceback")
    OUT[shape + "/json"] = np.frombuffer(json.dumps(rec).encode(), np.uint8)
    run = dryrun.make_run_config("smollm-135m", shape)
    params = dryrun._abstract_params(run)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(k.key for k in path)
        OUT[shape + "/param/" + key] = np.array([leaf.size, leaf.dtype.itemsize], np.int64)
'''


@pytest.fixture(scope="module")
def case():
    """The reference's subprocess, started first; the port's cells beside it."""
    import json
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, _BODY, {"unused": np.zeros(1)}, 8, 600)
        port = {shape: dryrun.run_cell("smollm-135m", shape, False, mesh_shape=(8, 1),
                                       fsdp_mode=mode) for shape, mode in CELLS}
        out = ref.result()
    recs = {shape: json.loads(out[shape + "/json"].tobytes()) for shape, _ in CELLS}
    return {"ref": out, "ref_rec": recs, "port": port}


# ------------------------------------------------------- the counters vs hlo_stats


def _port_collective(kind: str) -> dict:
    """The same collective on the stacked backend, (8, n) f32 rank rows,
    under the counters."""
    gen = torch.Generator().manual_seed(0)
    tp = StackedMesh(data=2, model=4)
    with CS.counting(n_devices=8) as st:
        if kind == "tp-all-gather":
            C.over_axis(torch.randn(8, ROWS, N, generator=gen), tp, "model",
                        C.ring_allgather_local)
        elif kind == "tp-reduce-scatter":
            C.over_axis(torch.randn(8, ROWS, 4 * N, generator=gen), tp, "model",
                        C.ring_reduce_scatter_local)
        elif kind == "all-gather":
            C.make_allgather(MESH8, "data", "xla")(torch.randn(8, N, generator=gen))
        elif kind == "reduce-scatter":
            C.make_reduce_scatter(MESH8, "data", "ring")(torch.randn(8, 8 * N, generator=gen))
        elif kind == "all-reduce":
            x = torch.randn(8, N, generator=gen)
            C.make_allgather(MESH8, "data", "ring")(
                C.make_reduce_scatter(MESH8, "data", "ring")(x))
        elif kind == "collective-permute":
            CS.record("collective-permute", 8, N * 4, 1)   # the port moves no lone ppermute
        else:
            C.make_broadcast(MESH8, "data", n_chunks=CHUNKS)(torch.randn(8, N, generator=gen))
    return st.as_dict()


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter", "all-reduce",
                                  "collective-permute", "broadcast", "tp-all-gather",
                                  "tp-reduce-scatter"])
def test_counters_equal_hlo_stats(case, kind):
    """Each kind's per-device and total bytes, as exact integers, equal
    hlo_stats's on the reference's compiled collective (the ring all-reduce
    counted as its reduce-scatter and gather; the pipelined broadcast's C +
    P - 2 ppermutes, its scan's trip count given to hlo_stats; a gather and
    a reduce-scatter over ``model`` of (2, 4) of a rank's (3, n) block, whose
    3 rows ``over_axis`` folds into its groups)."""
    ref = case["ref"]
    got = _port_collective(kind)
    assert got["per_device_total"] == int(ref[f"coll/{kind}/per_device_total"])
    assert got["total_bytes"] == int(ref[f"coll/{kind}/total_bytes"])
    if kind != "all-reduce":
        want = {k.split("/")[-1]: int(v) for k, v in ref.items()
                if k.startswith(f"coll/{kind}/kind/")}
        assert got["per_device_bytes"] == want


def test_per_device_bytes_formulas():
    """hlo_stats's five ring formulas, from one rank's result bytes r and the
    group size g."""
    r, g = 4096, 8
    want = {"all-gather": r * 7 // 8, "reduce-scatter": r * 7, "all-reduce": 2 * r * 7 // 8,
            "all-to-all": r * 7 // 8, "collective-permute": r}
    for kind, v in want.items():
        assert CS.per_device_bytes(kind, r, g) == v
        with CS.counting(n_devices=16) as st:
            CS.record(kind, g, r, 2)
        assert st.as_dict()["total_bytes"] == v * (16 if kind == "collective-permute" else g)
        assert st.records == [(kind, g, r, 2)]
    assert not CS.recording()


# --------------------------------------------------------- the slice vs run_cell


@pytest.mark.parametrize("shape,mode", CELLS)
def test_run_cell_matches_reference(case, shape, mode):
    got, want, ref = case["port"][shape], case["ref_rec"][shape], case["ref"]
    assert got["ok"], got.get("traceback")
    assert got["analytic"] == want["analytic"]
    assert set(want) - {"lower_s", "compile_s", "total_s"} <= set(got)
    for key in ("arch", "shape", "multi_pod", "fsdp_mode", "grad_accum", "remat", "mesh_shape",
                "serve_replicate", "moe_groups"):
        assert got[key] == want[key], key
    assert got["mesh"]["shape"] == want["mesh"]["shape"]
    assert got["mesh"]["n_devices"] == want["mesh"]["n_devices"] == 8
    # arguments: the port's token ids are int64, the reference's int32
    run = make_run_config("smollm-135m", shape)
    tokens = {"prefill": run.shape.global_batch * run.shape.seq_len, "decode": 0}[
        run.shape.kind] // 8 * 4
    arg, ref_arg = (r["memory_analysis"]["argument_size_in_bytes"] for r in (got, want))
    assert abs(arg - tokens - ref_arg) <= 0.01 * ref_arg, (arg, tokens, ref_arg)
    assert abs(got["memory_analysis"]["output_size_in_bytes"]
               - want["memory_analysis"]["output_size_in_bytes"]) <= 0.01 * ref_arg
    # collectives: what the reference's parameter shapes imply
    params = {k[len(shape) + 7:]: v for k, v in ref.items() if k.startswith(shape + "/param/")}
    implied = sum(int(n) * int(b) * 7 // 8 for k, (n, b) in params.items() if "ln" not in k)
    embed = int(np.prod(params["embed"])) * 7 // 8
    implied += embed if run.model.tie_embeddings else 0
    coll = got["collectives_hlo"]
    assert coll["per_device_total"] == implied
    assert set(coll["per_device_bytes"]) == {"all-gather"}
    # and the reference's HLO: bf16 widened to f32 (2x); the ring steps'
    # scan nested in the layer scan counted once a layer (1 of 7 steps)
    hlo = want["collectives_hlo"]["per_device_bytes"]
    if mode == "mcast_ring":
        layers = coll["per_device_total"] - 2 * embed
        assert hlo["collective-permute"] == 2 * layers // 7
        assert hlo["all-gather"] == 4 * embed
    else:
        assert 2 * coll["per_device_total"] > hlo["all-gather"] > 1.5 * coll["per_device_total"]
    flops = got["cost_analysis_raw"]["flops"]
    if shape == "decode_32k":
        assert flops == want["analytic"]["model_flops"]
    else:
        assert 0.9 * want["analytic"]["impl_flops"] < flops <= want["analytic"]["impl_flops"]


# ------------------------------------------------- the train step's collectives


class _Calls:
    """Every gather and reduce-scatter ``core/collectives.py`` runs, by the
    shards' shape (..., P, n), as ``chip_smoke._CallList`` records them."""

    def __init__(self, monkeypatch):
        self.calls = []
        gather, transpose, plain = C.ring_allgather, C.ring_allgather_transpose, \
            C.plain_allgather_local

        def g(x, schedule, out=None):
            self.calls.append(("all-gather", x.shape[-2:], x.element_size()))
            return gather(x, schedule, out)

        def t(y, schedule):
            self.calls.append(("reduce-scatter", y.shape[-2:], y.element_size()))
            return transpose(y, schedule)

        def p(x):
            out = plain(x)
            self.calls.append(("all-gather", x.shape[-2:], x.element_size()))
            if out.requires_grad:   # its backward, where autograd runs it
                out.register_hook(lambda _: self.calls.append(
                    ("reduce-scatter", x.shape[-2:], x.element_size())))
            return out

        monkeypatch.setattr(C, "ring_allgather", g)
        monkeypatch.setattr(C, "ring_allgather_transpose", t)
        monkeypatch.setattr(C, "plain_allgather_local", p)

    def implied(self) -> dict:
        per, counts = {}, {}
        for kind, (p, n), itemsize in self.calls:
            per[kind] = per.get(kind, 0) + (p - 1) * n * itemsize
            counts[kind] = counts.get(kind, 0) + 1
        return {"per_device_bytes": per, "counts": counts}


TRAIN = ShapeConfig("t", "train", 32, 8)


def _train_run(mode: str) -> RunConfig:
    return RunConfig(model=SMALL, shape=TRAIN, collective=CollectiveConfig(fsdp_mode=mode))


@pytest.mark.parametrize("mode", ["xla", "mcast", "mcast_bcast"])
def test_train_step_counts_its_backward(monkeypatch, mode):
    """A reduced smollm-135m train step on (data=8) on the CPU: the
    counters equal the bytes and counts its calls imply, the backward's
    reduce-scatters included (one a gather that needs a gradient, the
    recompute's gathers none); the same step on meta tensors, the
    dry-run's, counts the same (the counters read shapes alone)."""
    run = _train_run(mode)
    calls = _Calls(monkeypatch)
    _, _, step = make_train_step(run, MESH8, device="cpu")
    state = init_state(run, MESH8, bridge.random_params(SMALL, 0), device="cpu")
    batch = SyntheticPipeline(SMALL, TRAIN, device="cpu").next_batch(0)
    with CS.counting(n_devices=8) as st:
        step(state, batch)
    got = st.as_dict()
    implied = calls.implied()
    assert got["per_device_bytes"] == implied["per_device_bytes"]
    assert got["counts"] == implied["counts"]
    leaves = 7 * SMALL.num_layers   # a layer's dp-sharded leaves, gathered again in remat
    assert got["counts"]["reduce-scatter"] == got["counts"]["all-gather"] - leaves
    monkeypatch.undo()
    meta = dryrun.measure_step(run, MESH8)["collectives"].as_dict()
    assert meta == got


def test_tracker_flops_equal_flop_counter_mode():
    """The tracker's cached counts equal ``FlopCounterMode``'s on the same
    meta step (a reduced train step: forward, recompute, backward, #3's
    fake included)."""
    run = _train_run("mcast")
    got = dryrun.measure_step(run, MESH8)["flops"]
    cell = dryrun._Cell(run, MESH8)
    with FlopCounterMode(display=False) as fc:
        cell.step()
    assert got == fc.get_total_flops() > 0
    assert M.launches == M.launches_wmma == M.launches_f32 == 0


def test_tracker_follows_live_bytes():
    """Storages made inside the tracker count until they die, views and
    saved tensors with their storage; arguments (``hold``) do not."""
    arg = torch.empty(1000, device="meta")
    tr = dryrun._StepTracker()
    assert tr.hold([arg, arg.view(10, 100)]) == 4000
    with tr:
        a = arg * 2                          # 4,000 B
        v = a.view(10, 100)
        del a                                # the view keeps it
        b = torch.empty(500, dtype=torch.float64, device="meta")   # 4,000 B
        del v
        c = b + 1                            # 4,000 B, b still alive
        del b, c
        d = torch.empty(100, device="meta")  # 400 B
    assert tr.peak == 8000 and tr.live == 400
    del d
    assert tr.live == 0


# ----------------------------------------------------- the production mesh


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
    ("rwkv6-7b", "long_500k"), ("recurrentgemma-9b", "decode_32k"),
    ("phi-3-vision-4.2b", "decode_32k"), ("whisper-base", "decode_32k")])
def test_dryrun_cell_on_the_production_mesh(arch, shape):
    """One cell of each family at full width on the stacked (16, 16) mesh,
    256 ranks on meta: ok, with flops, collective bytes and a peak."""
    rec = dryrun.run_cell(arch, shape, False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"]["n_devices"] == 256 and rec["mesh"]["stacked_ranks"] == 256
    assert rec["cost_analysis_raw"]["flops"] > 0
    assert rec["collectives_hlo"]["per_device_total"] > 0
    mem = rec["memory_analysis"]
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] > 0
    assert mem["process_peak_bytes"] >= mem["process_argument_bytes"] > 0
    assert rec["fits"] == (mem["peak_bytes"] <= rec["card"]["total_memory"])
    assert K.allgather_launches == K.allgather_transpose_launches == 0


def test_dryrun_cli_writes_records(capsys):
    with tempfile.TemporaryDirectory() as out:
        with pytest.raises(SystemExit) as exit_:
            dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out", out,
                         "--kv-int8"])
        assert exit_.value.code == 0
        files = os.listdir(out)
        assert files == ["smollm-135m__decode_32k__1pod__kvi8.json"]
    assert "[dryrun] done: 1/1 OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k"])
    assert exit_.value.code == 0 and "SKIP" in capsys.readouterr().out


# ------------------------------------------------------------ meta support


def test_meta_wrappers_and_cache_write():
    """On meta tensors the kernels' wrappers give empty outputs of their
    shapes and dtypes and count no launch; the decode cache's write runs;
    ``device_params`` lays out the tree without drawing."""
    x = torch.empty(2, 8, 24, dtype=torch.bfloat16, device="meta")
    sched = C._bidi_schedule(8, 24)
    out = K.ring_allgather(x, sched)
    assert out.shape == (2, 8, 8, 24) and out.dtype == torch.bfloat16 and out.is_meta
    t = K.ring_allgather_transpose(out, sched)
    assert t.shape == (2, 8, 24) and t.is_meta
    assert K.ring_step(out, 0) is out
    y = M.matmul(torch.empty(4, 8, 16, device="meta"), torch.empty(4, 16, 32, device="meta"))
    assert y.shape == (4, 8, 32) and y.dtype == torch.float32
    assert K.allgather_launches == K.allgather_transpose_launches == K.launches == 0
    assert M.launches == M.launches_f32 == 0
    cache = torch.empty(3, 2, 16, 4, device="meta")
    pos = torch.empty(3, dtype=torch.long, device="meta")
    assert attention.cache_scatter_update(cache, torch.empty(3, 2, 4, device="meta"),
                                          pos) is cache
    tree = bridge.device_params(SMALL, MESH8, MeshConfig(), seed=0, dtype=torch.bfloat16,
                                device="meta")
    want = bridge.device_params(SMALL, MESH8, MeshConfig(), seed=0, dtype=torch.bfloat16,
                                device="cpu")
    from repro_torch.sharding.specs import tree_leaves
    for a, b in zip(tree_leaves(tree), tree_leaves(want)):
        assert a.local.is_meta and a.local.shape == b.local.shape
        assert a.local.dtype == b.local.dtype and a.spec == b.spec
        assert a.local.stride() == b.local.stride()


def test_cache_write_drops_out_of_range_without_nonzero():
    """The decode cache's write: a position outside [0, S) leaves the cache
    as it was, in one scatter (no ``nonzero``)."""
    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(2, 3, 2, 5, 4, generator=gen)
    new = torch.randn(2, 3, 2, 4, generator=gen)
    pos = torch.tensor([[0, 4, 5], [-1, 2, 7]])
    want = cache.clone()
    for i in range(2):
        for j in range(3):
            if 0 <= pos[i, j] < 5:
                want[i, j, :, pos[i, j]] = new[i, j]
    got = attention.cache_scatter_update(cache.clone(), new, pos)
    assert torch.equal(got, want)


def test_new_modules_import_neither_jax_nor_repro():
    """The compressor, the counters and the dry-run (a production cell on
    meta) load no jax and no module of the JAX package."""
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import dryrun, collective_stats\n"
        "from repro_torch.optim import compression\n"
        "rec = dryrun.run_cell('smollm-135m', 'decode_32k', False)\n"
        "assert rec['ok'], rec.get('traceback')\n"
        "comp, err = compression.make_compressor({'w': torch.ones(300)})\n"
        "g, e = comp({'w': torch.ones(300)}, err)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]

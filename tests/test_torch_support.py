"""Shared helpers of the PyTorch port's tests, and the port's own contract:
the parameter bridge, import hygiene, and CUDA-by-default entry points.

The JAX reference runs as the JAX package's tests run it: in-process on one
device, or in a subprocess with 8 fake CPU devices (``run_reference``) for
mesh runs, always on a mesh with Auto axis types. Inputs are numpy arrays
made from a seed and go into both packages.
"""
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import MeshConfig as RefMeshConfig
from repro.configs import ShapeConfig as RefShapeConfig
from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.sharding import specs as ref_specs
from repro_torch import bridge
from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, get_model_config, reduced)
from repro_torch.core.engine import FabricParams, WorkerParams
from repro_torch.core.packet import simulate_packet_allgather, simulate_packet_broadcast
from repro_torch.core.protocol import allgather_time, broadcast_time
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill_step
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding import specs
from repro_torch.sharding.fsdp import gather_dim, gather_leaf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# Prelude of every reference subprocess: IN holds the inputs, OUT collects
# the outputs; meshes use Auto axis types (jax 0.9 defaults to Explicit).
_PRELUDE = '''
import sys
import numpy as np
import jax
from jax.sharding import AxisType

def ref_mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

def unflatten(flat, prefix):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *parents, leaf = key[len(prefix):].split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree

IN = dict(np.load(sys.argv[1]))
OUT = {}
'''


def run_reference(body: str, inputs: dict, n_devices: int = 8,
                  timeout: int = 900) -> dict:
    """Run ``body`` in a subprocess with ``n_devices`` fake CPU devices; it
    reads numpy arrays from ``IN`` and stores results in ``OUT``. XLA runs
    single-threaded there: the references are small and compile-bound, and
    with several test workers each running one, thread pools per process
    would oversubscribe the cores."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n_devices} "
                        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, **inputs)
        code = _PRELUDE + body + "\nnp.savez(sys.argv[2], **OUT)\n"
        res = subprocess.run([sys.executable, "-c", code, fin, fout], env=env,
                             capture_output=True, text=True, timeout=timeout)
        if res.returncode != 0:
            raise AssertionError(f"reference subprocess failed:\n{res.stderr[-4000:]}")
        with np.load(fout) as out:
            return dict(out)


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def random_tree(cfg, seed: int) -> dict:
    """A dense parameter tree in the reference's init scales, with random
    norm scales so that the (1 + w) of rms_norm is exercised."""
    tree = bridge.random_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    for holder, name in ((tree, "final_ln"), (tree["blocks"], "ln1"),
                         (tree["blocks"], "ln2")):
        holder[name] = (0.1 * rng.standard_normal(holder[name].shape)).astype(np.float32)
    return tree


def serve_run(cfg, mode: str, batch: int, seq: int, kind: str = "prefill",
              n_chains: int = 2) -> RunConfig:
    return RunConfig(model=cfg, shape=ShapeConfig("t", kind, seq, batch),
                     collective=CollectiveConfig(fsdp_mode=mode, n_chains=n_chains))


SMALL = reduced(get_model_config("smollm-135m"))


# ------------------------- the model axis for the MoE, rwkv, hybrid, encdec

TP_MESHES = {"2x4": (2, 4), "4x2": (4, 2)}
TP_MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]

# The reference's runs of ``tp_family_cases``: each case on an Auto mesh,
# in xla (the port's modes are held against it and bitwise to each other):
# its prefill; 5 decode steps from that prefill's cache, handed to decode
# as the port's ``transformer.decode_cache`` hands it (the dense cache and
# the encdec's self-attention padded, the rwkv states as they are, the
# hybrid's window into its rings by position); training steps on the same
# mesh, and where asked on one device (rwkv's grad norm yardstick,
# ROADMAP §3). A case's "layers" cut the served model, "train_layers" the
# trained one (None: ``reduced``'s depth).
TP_FAMILY_BODY = '''
import dataclasses
import jax.numpy as jnp
import torch
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced)
from repro.optim import adamw
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
from repro.runtime.train_loop import TrainState, jit_train_step, make_train_step
from repro_torch.configs import get_model_config as port_model_config
from repro_torch.configs import reduced as port_reduced
from repro_torch.models.transformer import decode_cache

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        OUT[prefix + key] = np.asarray(leaf)

def mesh_config(shape):
    class M(MeshConfig):
        @property
        def shape(self): return shape
    return M()

def with_experts(cfg, experts):
    return cfg if not experts else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, n_routed_experts=experts))

for name, c in CASES.items():
    cfg = with_experts(reduced(get_model_config(c["arch"]), layers=c["layers"]), c["experts"])
    train_cfg = with_experts(reduced(get_model_config(c["arch"]), layers=c.get("train_layers")),
                             c["experts"])
    mesh = ref_mesh(c["mesh"], ("data", "model"))
    if "serve" in c:
        b, s, cache_len, steps = c["serve"]
        params = jax.tree.map(jnp.asarray, unflatten(IN, name + "/serve/"))
        batch = {k: IN[name + "/in/" + k] for k in c["inputs"]}
        _, step = jit_prefill_step(RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", s, b)),
                                   mesh)
        logits, cache = step(params, batch)
        OUT[name + "/logits"] = np.asarray(logits)
        put(name + "/cache/", cache)
        port_cfg = port_reduced(port_model_config(c["arch"]), layers=c["layers"])
        host = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), cache)
        handed = jax.tree.map(lambda t: t.numpy(), decode_cache(port_cfg, host, s, cache_len))
        _, dec = jit_decode_step(RunConfig(model=cfg, shape=ShapeConfig("d", "decode",
                                                                         cache_len, b)), mesh)
        state = ServeState(handed, np.full((b,), s, np.int32))
        tok = np.argmax(OUT[name + "/logits"], -1).astype(np.int32)
        lgs, toks = [], [tok]
        for _ in range(steps):
            lg, state = dec(params, state, tok)
            tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
            lgs.append(np.asarray(lg))
            toks.append(tok)
        OUT[name + "/decode/logits"] = np.stack(lgs)
        OUT[name + "/decode/tokens"] = np.stack(toks, 1)
    if "train" in c:
        b, s, steps = c["train"]
        shape = ShapeConfig("t", "train", s, b)
        runs = {"mesh": jit_train_step(RunConfig(model=train_cfg, shape=shape,
                                                 mesh=mesh_config(c["mesh"]),
                                                 train=TrainConfig(steps=5),
                                                 collective=CollectiveConfig(fsdp_mode="xla",
                                                                             n_chains=2)),
                                       mesh)[1]}
        if c.get("single"):
            runs["single"] = jax.jit(make_train_step(RunConfig(model=train_cfg, shape=shape,
                                                               train=TrainConfig(steps=5)),
                                                     None)[2])
        for where, jstep in runs.items():
            params = jax.tree.map(jnp.asarray, unflatten(IN, name + "/train/"))
            state = TrainState(params, adamw.init(params))
            for i in range(steps):
                batch = {k: IN[f"{name}/batch{i}/{k}"] for k in c["batch"]}
                state, m = jstep(state, batch)
                for key, val in m.items():
                    OUT[f"{name}/{where}/{key}{i}"] = np.asarray(val)
            put(f"{name}/{where}/params/", state.params)
'''


def tp_family_inputs(name: str, case: dict, serve_tree, train_tree, serve_batch: dict,
                     batches: list) -> dict:
    """The reference subprocess's inputs of one case of ``TP_FAMILY_BODY``."""
    out = {}
    if serve_tree is not None:
        out.update({f"{name}/serve/{k}": v for k, v in flatten(serve_tree).items()})
        out.update({f"{name}/in/{k}": v.numpy().astype(np.int32 if k == "tokens" else
                                                          np.float32)
                    for k, v in serve_batch.items()})
    if train_tree is not None:
        out.update({f"{name}/train/{k}": v for k, v in flatten(train_tree).items()})
        for i, batch in enumerate(batches):
            out.update({f"{name}/batch{i}/{k}": v.numpy().astype(
                np.float32 if v.is_floating_point() else np.int32) for k, v in batch.items()})
    return out


def _clone(tree):
    if tree is None or torch.is_tensor(tree):
        return None if tree is None else tree.clone()
    return {k: _clone(v) for k, v in tree.items()}


def tp_serve_port(cfg, tree, mesh: StackedMesh, batch: dict, cache_len: int, steps: int,
                  modes=TP_MODES) -> dict:
    """The port's side of a serving case: a prefill in every mode and with
    ``serve_params_replicated`` (``"repl"``, mcast), then ``steps`` decode
    steps from the xla prefill's cache (``transformer.decode_cache``):
    {mode: (logits, cache), "decode": (logits (steps, B, V), tokens (B,
    steps + 1))}."""
    from repro_torch.models import transformer
    from repro_torch.runtime.serve_loop import ServeState

    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    b, s = batch["tokens"].shape
    out = {}
    for mode in list(modes) + ["repl"]:
        run = serve_run(cfg, "mcast" if mode == "repl" else mode, b, s)
        if mode == "repl":
            run = run.replace(collective=dataclasses.replace(run.collective,
                                                             serve_params_replicated=True))
        _, _, prefill = make_prefill_step(run, mesh, device="cpu")
        out[mode] = prefill(params, batch)
    logits, pre = out["xla"]
    _, _, decode = make_decode_step(serve_run(cfg, "xla", b, cache_len, "decode"), mesh,
                                    device="cpu")
    state = ServeState(transformer.decode_cache(cfg, _clone(pre), s, cache_len),
                       torch.full((b,), s, dtype=torch.long))
    tok = logits.argmax(-1)
    lgs, toks = [], [tok]
    for _ in range(steps):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    out["decode"] = (torch.stack(lgs), torch.stack(toks, 1))
    return out


def tp_train_port(cfg, tree, mesh: StackedMesh, batches: list, mode: str):
    """The port's side of a training case: ``len(batches)`` steps in
    ``mode`` -> (metrics a step, the global parameters after them)."""
    from repro_torch.sharding.fsdp import at_use

    b, s = batches[0]["tokens"].shape
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", s, b),
                    train=TrainConfig(steps=5),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, tree, device="cpu")
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                     MeshConfig()))
    return metrics, params




def check_tpf_launches(monkeypatch, cs, cfg, mesh: StackedMesh, mode: str, batch: dict,
                       train_shape: ShapeConfig) -> None:
    """The #1, #1b and #3 launches (by the matmul's path) of a prefill of
    ``batch``, a decode step from its cache and a train step (remat="full")
    of ``cfg`` on ``mesh`` in ``mode``, counted on the CPU by spies on
    ``core.collectives``' ring kernels and the matmul, against
    ``chip_smoke.tpf_launches`` (the counts phases 3i and 4i assert on the
    card); the products' shapes against ``chip_smoke.tpf_matmul_cases``.
    On the card each gather, transpose and product is one launch (a
    schedule of at most 128 entries)."""
    from collections import Counter

    from repro_torch.core import collectives as C
    from repro_torch.kernels import collective_matmul as M
    from repro_torch.models import transformer
    from repro_torch.runtime.serve_loop import ServeState
    keys = ("ring_allgather", "ring_allgather_transpose", "matmul", "matmul_wmma", "matmul_f32")
    counts, shapes = dict.fromkeys(keys, 0), Counter()

    def spy(name, fn):
        def wrapped(*args, **kw):
            key = name
            if name == "matmul":
                x, w = args[:2]
                key = {"wgmma": "matmul", "wmma": "matmul_wmma", "f32": "matmul_f32"}[
                    M.path(x, w)]
                shapes[(x.shape[0], x.shape[1], x.shape[2], w.shape[2], x.dtype)] += 1
            counts[key] += 1
            return fn(*args, **kw)
        return wrapped

    for module, name in ((C, "ring_allgather"), (C, "ring_allgather_transpose"), (M, "matmul")):
        monkeypatch.setattr(module, name, spy(name, getattr(module, name)))

    def take():
        out, got = dict(counts), Counter(shapes)
        counts.update(dict.fromkeys(counts, 0))
        shapes.clear()
        return out, got

    def want_shapes(cases):
        out = Counter()
        for (r, m, k, n, *_, dt), c in cases.items():
            out[(r, m, k, n, dt)] += c
        return out

    b, s = batch["tokens"].shape
    bl = b // mesh.shape["data"]
    moe = cfg.family == "moe"
    params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                             dtype=torch.bfloat16, device="cpu")
    run = serve_run(cfg, mode, b, s)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    take()
    logits, pre = prefill(params, batch)
    got, got_shapes = take()
    assert got == cs.tpf_launches(cfg, mesh, mode, "prefill", s)
    assert got_shapes == want_shapes(cs.tpf_matmul_cases(
        cfg, mesh, bl * s, "prefill", head_m=bl, cap=cs.moe_capacity(cfg, b * s) if moe else 0))
    state = ServeState(transformer.decode_cache(cfg, pre, s, s + 4), torch.full((b,), s))
    decode(params, state, logits.argmax(-1))
    got, got_shapes = take()
    assert got == cs.tpf_launches(cfg, mesh, mode, "decode", s)
    assert got_shapes == want_shapes(cs.tpf_matmul_cases(cfg, mesh, bl, "decode", head_m=bl,
                                                         cap=b))
    tb, seq = train_shape.global_batch, train_shape.seq_len
    trun = RunConfig(model=cfg, shape=train_shape, collective=CollectiveConfig(fsdp_mode=mode))
    _, _, step = make_train_step(trun, mesh, device="cpu")
    tstate = init_state(trun, mesh, bridge.random_params(cfg, 0), device="cpu")
    take()
    step(tstate, SyntheticPipeline(cfg, train_shape, device="cpu").next_batch(0))
    got, got_shapes = take()
    assert got == cs.tpf_launches(cfg, mesh, mode, "train", seq)
    tl = tb // mesh.shape["data"]
    assert got_shapes == want_shapes(cs.tpf_matmul_cases(
        cfg, mesh, tl * seq, "train", head_m=tl * min(seq, 512), chunks=-(-seq // 512),
        cap=cs.moe_capacity(cfg, tb * seq) if moe else 0))


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module's tests: their tensors are small,
    and several test workers, each with a thread per core, oversubscribe
    the cores (``pytest.mark.usefixtures`` at a module's top)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------- bridge


@pytest.mark.parametrize("axes,multi_pod", [
    ({"data": 8, "model": 1}, False),
    ({"data": 2, "model": 4}, False),
    ({"pod": 2, "data": 4, "model": 1}, True),
])
def test_bridge_round_trip(axes, multi_pod):
    """Every rank's plain-gathered copy of every leaf, gathered over
    ``model`` too where it is split there, is the global leaf, and sharded
    leaves hold 1/R of it."""
    mesh, mesh_cfg = StackedMesh(**axes), MeshConfig(multi_pod=multi_pod)
    tree = random_tree(SMALL, 0)
    params = bridge.to_torch(tree, mesh, mesh_cfg, dtype=torch.float32, device="cpu")
    dp = specs.dp_axes(mesh_cfg)
    flat_np, flat_t = flatten(tree), flatten(params)
    assert flat_np.keys() == flat_t.keys()
    for key, a in flat_np.items():
        leaf = flat_t[key]
        assert leaf.local.shape[0] == mesh.n_ranks
        if specs.is_sharded(leaf.spec, dp):
            assert leaf.local.numel() == a.size, key
        full = gather_leaf(leaf.local, leaf.spec, mesh, dp, "xla", 1)
        if specs.is_tp_sharded(leaf.spec, mesh):
            dim = [i for i, e in enumerate(leaf.spec) if "model" in specs.entry_axes(e)][0]
            full, _ = gather_dim(full, leaf.spec, "model", dim, mesh, "ring", 1)
        for r in range(mesh.n_ranks):
            np.testing.assert_array_equal(full[r].numpy(), a, err_msg=key)


def test_bridge_without_mesh_keeps_one_rank():
    params = bridge.to_torch(random_tree(SMALL, 0), None, MeshConfig(),
                             dtype=torch.float32, device="cpu")
    for leaf in flatten(params).values():
        assert leaf.local.shape[0] == 1 and leaf.spec == ()


def test_bridge_keeps_norm_scales_f32():
    params = bridge.to_torch(random_tree(SMALL, 0), StackedMesh(data=8, model=1),
                             MeshConfig(), dtype=torch.bfloat16, device="cpu")
    assert params["blocks"]["attn"]["wq"].local.dtype == torch.bfloat16
    assert params["blocks"]["ln1"].local.dtype == torch.float32
    assert params["final_ln"].local.dtype == torch.float32


def test_gelu_dense_config_gets_the_reference_mlp():
    """A dense config whose act is not swiglu gets the reference's plain
    two-layer MLP (``layers.mlp_init``: w_in (d, f) and w_out (f, d)), not a
    SwiGLU tree: the leaves and shapes of the reference's ``init_params``,
    the analytic parameter count, and the forward and prefill logits of the
    reference on the same numpy weights within the serving tolerance (1e-5),
    through mcast gathers on 8 ranks."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.models import build_model as ref_build_model
    from repro.models.model_builder import count_params_analytic as ref_count
    from repro_torch.models.model_builder import count_params_analytic
    from repro_torch.sharding.ctx import use_ctx

    cfg = dataclasses.replace(SMALL, act="gelu")
    ref_cfg = dataclasses.replace(ref_reduced(ref_model_config("smollm-135m")), act="gelu")
    tree = random_tree(cfg, 0)
    ref_api = ref_build_model(ref_cfg)
    ref_tree = flatten(jax.tree_util.tree_map(np.asarray,
                                              ref_api.init_params(jax.random.PRNGKey(0))))
    mine = flatten(tree)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in ref_tree.items()}
    assert "blocks/mlp/w_in" in mine and "blocks/mlp/w_gate" not in mine
    # the analytic count leaves out the norm scales
    weights = sum(v.size for k, v in mine.items()
                  if k.split("/")[-1] not in ("ln1", "ln2", "final_ln"))
    assert weights == count_params_analytic(cfg) == ref_count(ref_cfg)
    for name, scale in (("w_in", 1 / np.sqrt(cfg.d_model)), ("w_out", 1 / np.sqrt(cfg.d_ff))):
        raw = bridge.random_params(cfg, 0)["blocks"]["mlp"][name]
        assert abs(raw.std() / scale - 1) < 0.05, name
    b, seq = 8, 16
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, seq)).astype(np.int32)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    want_hidden = np.asarray(ref_api.forward_fn(ref_params, {"tokens": jnp.asarray(tokens)}))
    want_logits, _ = ref_api.prefill_fn(ref_params, {"tokens": jnp.asarray(tokens)})
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    api, ctx, prefill = make_prefill_step(serve_run(cfg, "mcast", b, seq), mesh, device="cpu")
    with use_ctx(ctx):
        hidden = api.forward_fn(params, {"tokens": torch.from_numpy(tokens).long()})
    logits, _ = prefill(params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(hidden.numpy(), want_hidden, rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=0, atol=1e-5)


def _fake_mesh(shape: dict):
    return SimpleNamespace(shape=shape)


def _norm(tree):
    """Specs as tuples, a one-axis tuple entry written as the axis name (the
    form PartitionSpec normalises to)."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in tree)


@pytest.mark.parametrize("axes,multi_pod", [
    ({"data": 8, "model": 1}, False),
    ({"data": 2, "model": 4}, False),
    ({"pod": 2, "data": 4, "model": 1}, True),
])
def test_specs_match_reference(axes, multi_pod):
    """param_pspecs / batch_pspecs / cache_pspecs equal the reference's
    (which read only ``mesh.shape``) on the same global shapes."""
    mesh = StackedMesh(**axes)
    fake = _fake_mesh(dict(axes))
    tree = random_tree(SMALL, 0)
    got = specs.param_pspecs(tree, mesh, MeshConfig(multi_pod=multi_pod))
    want = ref_specs.param_pspecs(tree, fake, RefMeshConfig(multi_pod=multi_pod))
    assert _norm(got) == _norm(want)
    shape = ShapeConfig("t", "prefill", 32, 8)
    ref_cfg = ref_reduced(ref_model_config("smollm-135m"))
    got_b = specs.batch_pspecs(SMALL, shape, mesh, MeshConfig(multi_pod=multi_pod))
    want_b = ref_specs.batch_pspecs(ref_cfg, RefShapeConfig("t", "prefill", 32, 8), fake,
                                    RefMeshConfig(multi_pod=multi_pod))
    assert _norm(got_b) == _norm(want_b)
    cache = {"k": np.zeros((2, 8, 2, 32, 16)), "v": np.zeros((2, 8, 2, 32, 16))}
    got_c = specs.cache_pspecs(SMALL, cache, mesh, MeshConfig(multi_pod=multi_pod))
    want_c = ref_specs.cache_pspecs(ref_cfg, cache, fake, RefMeshConfig(multi_pod=multi_pod), 32)
    assert _norm(got_c) == _norm(want_c)
    assert P(*got["blocks"]["attn"]["wq"]) == want["blocks"]["attn"]["wq"]


# ------------------------------------------------------------ import hygiene


def test_port_imports_neither_jax_nor_repro():
    """Importing repro_torch and running a CPU prefill, decode and train
    step, a lossy packet broadcast and allgather, the collective layer's
    entry points (the allgather-matmul through ``kernels.ops``, the drain, a
    bucket broadcast and concurrent AG/RS, with the backwards of the first
    and the last), and a supervised run at a replicated
    batch with a failure, its checkpoints and an elastic restore, loads no
    jax and no module of the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch import bridge\n"
        "from repro_torch.configs import (CollectiveConfig, MeshConfig, RunConfig,\n"
        "                                 ShapeConfig, get_model_config, reduced)\n"
        "from repro_torch.launch.mesh import StackedMesh\n"
        "from repro_torch.runtime.serve_loop import (greedy_generate,\n"
        "                                            make_decode_step, make_prefill_step)\n"
        "cfg = reduced(get_model_config('smollm-135m'))\n"
        "mesh = StackedMesh(data=8, model=1)\n"
        "params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),\n"
        "                         dtype=torch.float32, device='cpu')\n"
        "run = RunConfig(model=cfg, shape=ShapeConfig('p', 'prefill', 16, 8),\n"
        "                collective=CollectiveConfig(fsdp_mode='mcast'))\n"
        "_, _, pre = make_prefill_step(run, mesh, device='cpu')\n"
        "_, _, dec = make_decode_step(run, mesh, device='cpu')\n"
        "toks = torch.zeros((8, 16), dtype=torch.long)\n"
        "out = greedy_generate(pre, dec, params, toks, 2, 17)\n"
        "assert out.shape == (8, 18)\n"
        "from repro_torch.data.pipeline import SyntheticPipeline\n"
        "from repro_torch.runtime.train_loop import init_state, make_train_step\n"
        "run = RunConfig(model=cfg, shape=ShapeConfig('t', 'train', 16, 8),\n"
        "                collective=CollectiveConfig(fsdp_mode='mcast_bcast'))\n"
        "_, _, step = make_train_step(run, mesh, device='cpu')\n"
        "state = init_state(run, mesh, bridge.random_params(cfg, 0), device='cpu')\n"
        "state, m = step(state, SyntheticPipeline(cfg, run.shape, device='cpu').next_batch(0))\n"
        "assert float(m['loss']) > 0\n"
        "from repro_torch.core import engine, packet, protocol\n"
        "r = packet.simulate_packet_broadcast(16, 1 << 18, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), loss=0.01, device='cpu')\n"
        "assert r.completed and r.rounds\n"
        "assert protocol.broadcast_time(8, 1 << 16, device='cpu') > 0\n"
        "a = packet.simulate_packet_allgather(10, 1 << 16, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), 4, loss=0.01, device='cpu')\n"
        "assert a.completed and a.rounds\n"
        "assert protocol.allgather_time(8, 1 << 16, n_chains=2, device='cpu') > 0\n"
        "from repro_torch.core import collectives as C\n"
        "from repro_torch.kernels import ops, ring_allgather\n"
        "from repro_torch.sharding.fsdp import flatten_bucket\n"
        "x = torch.randn(8, 4, 16)\n"
        "y = ops.make_allgather_matmul(mesh, 'data')(x, torch.randn(16, 8))\n"
        "assert y.shape == (8, 32, 8)\n"
        "assert torch.equal(ring_allgather.local_double_buffer_drain(x), x)\n"
        "flat, unflatten = flatten_bucket({'b': x, 'a': [x[0]]}, pad_to=64)\n"
        "rows = flat.reshape(8, -1)\n"
        "assert torch.equal(C.make_broadcast(mesh, 'data', root=3)(rows)[0], rows[3])\n"
        "ag, rs = C.concurrent_ag_rs_local(x.reshape(8, -1), torch.randn(8, 16))\n"
        "assert ag.shape == (8, 512) and rs.shape == (8, 2)\n"
        "xg, wg = x.clone().requires_grad_(), torch.randn(16, 8, requires_grad=True)\n"
        "ops.make_allgather_matmul(mesh, 'data')(xg, wg).sum().backward()\n"
        "assert xg.grad.shape == x.shape and wg.grad.shape == (16, 8)\n"
        "ag = x.reshape(8, -1).clone().requires_grad_()\n"
        "sum(t.sum() for t in C.concurrent_ag_rs_local(ag, torch.randn(8, 16))).backward()\n"
        "assert ag.grad.shape == (8, 64)\n"
        "import tempfile\n"
        "from repro_torch.checkpoint import latest_step, restore, save\n"
        "from repro_torch.runtime.elastic import reshard_state, scale_plan\n"
        "from repro_torch.runtime.fault import FailureInjector, TrainSupervisor\n"
        "from repro_torch.launch.mesh import make_local_mesh, make_production_mesh\n"
        "d = tempfile.mkdtemp()\n"
        "run = RunConfig(model=cfg, shape=ShapeConfig('t', 'train', 16, 4),\n"
        "                collective=CollectiveConfig(fsdp_mode='mcast'))\n"
        "_, ctx, step = make_train_step(run, mesh, device='cpu')\n"
        "assert not ctx.shard_batch\n"
        "sup = TrainSupervisor(step_fn=step, ckpt_dir=d, ckpt_every=1,\n"
        "    pipeline=SyntheticPipeline(cfg, run.shape, device='cpu'),\n"
        "    injector=FailureInjector(fail_at_steps=(1,)))\n"
        "state, hist = sup.run(init_state(run, mesh, bridge.random_params(cfg, 0),\n"
        "                                 device='cpu'), 2)\n"
        "assert [h['step'] for h in hist] == [0, 1] and latest_step(d) == 2\n"
        "back, _ = restore(d, 2, state, mesh=StackedMesh(data=4, model=2),\n"
        "                  mesh_cfg=MeshConfig())\n"
        "moved = reshard_state(state, run, StackedMesh(data=2, model=4))\n"
        "assert scale_plan(2, 4, 8)['new_per_replica'] == 2\n"
        "assert make_production_mesh(multi_pod=True).n_ranks == 512\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_port_sources_name_neither_jax_nor_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b")
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    bad = [line for line in fh if pattern.match(line)]
                assert not bad, (f, bad)


# ---------------------------------------------------------- device defaults


def test_entry_points_default_to_cuda():
    """Entry points run on CUDA unless given device='cpu'; without a card
    they raise a clear error instead of falling back to the CPU."""
    mesh = StackedMesh(data=8, model=1)
    run = serve_run(SMALL, "mcast", 8, 16)
    tree = random_tree(SMALL, 0)
    train_run = serve_run(SMALL, "mcast", 8, 16, kind="train")
    calls = [
        lambda: build_model(SMALL),
        lambda: make_prefill_step(run, mesh),
        lambda: make_decode_step(run, mesh),
        lambda: bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32),
        lambda: make_train_step(train_run, mesh),
        lambda: init_state(train_run, mesh, tree),
        lambda: SyntheticPipeline(SMALL, train_run.shape),
        lambda: simulate_packet_broadcast(8, 1 << 16, FabricParams(), WorkerParams(),
                                          np.random.default_rng(0)),
        lambda: broadcast_time(8, 1 << 16),
        lambda: simulate_packet_allgather(8, 1 << 16, FabricParams(), WorkerParams(),
                                          np.random.default_rng(0), 2),
        lambda: allgather_time(8, 1 << 16),
    ]
    if torch.cuda.is_available():
        assert build_model(SMALL).init_cache(8, 4)["k"].device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert build_model(SMALL, device="cpu").init_cache(8, 4)["k"].device.type == "cpu"


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--fsdp-mode", "mcast_bcast"])
    out = capsys.readouterr().out
    assert "8 prompt + 3 new tokens" in out and "0 ring-allgather kernel launches" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "smollm-135m", "--smoke"])


def test_ctx_resolves_dims():
    from repro_torch.runtime.train_loop import make_ctx
    from repro_torch.sharding.ctx import get_ctx, mesh_axis_size, spec, use_ctx
    assert mesh_axis_size("dp") == 1 and get_ctx().mesh is None
    mesh = StackedMesh(pod=2, data=4, model=1)
    run = serve_run(SMALL, "mcast", 8, 16)
    run = run.replace(mesh=MeshConfig(multi_pod=True))
    with use_ctx(make_ctx(run, mesh)) as ctx:
        assert mesh_axis_size("dp") == 8 and mesh_axis_size("tp") == 1
        assert spec("dp", "sp", None) == (("pod", "data"), "model", None)
        assert ctx.shard_batch and ctx.gather_params is not None
    with use_ctx(make_ctx(run, mesh, for_decode=True)):
        assert spec("dp", "sp") == (("pod", "data"), None)
    with pytest.raises(ValueError, match="dp axes"):
        make_ctx(serve_run(SMALL, "mcast", 8, 16), mesh)

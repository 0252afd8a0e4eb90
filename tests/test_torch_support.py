"""Shared helpers of the PyTorch port's tests, and the port's own contract:
the parameter bridge, import hygiene, and CUDA-by-default entry points.

The JAX reference runs as the JAX package's tests run it: in-process on one
device, or in a subprocess with 8 fake CPU devices (``run_reference``) for
mesh runs, always on a mesh with Auto axis types. Inputs are numpy arrays
made from a seed and go into both packages.
"""
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
                                 get_model_config, reduced)
from repro_torch.core.engine import FabricParams, WorkerParams
from repro_torch.core.packet import simulate_packet_broadcast
from repro_torch.core.protocol import broadcast_time
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill_step
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding import specs
from repro_torch.sharding.fsdp import gather_leaf

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
                  timeout: int = 300) -> dict:
    """Run ``body`` in a subprocess with ``n_devices`` fake CPU devices; it
    reads numpy arrays from ``IN`` and stores results in ``OUT``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
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


# ------------------------------------------------------------------- bridge


@pytest.mark.parametrize("axes,multi_pod", [
    ({"data": 8, "model": 1}, False),
    ({"data": 2, "model": 4}, False),
    ({"pod": 2, "data": 4, "model": 1}, True),
])
def test_bridge_round_trip(axes, multi_pod):
    """Every rank's plain-gathered copy of every leaf is the global leaf, and
    sharded leaves hold 1/R of it."""
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
    step, a lossy packet broadcast, and the collective layer's entry points
    (the allgather-matmul through ``kernels.ops``, the drain, a bucket
    broadcast and concurrent AG/RS) loads no jax and no module of the JAX
    package."""
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
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
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

"""The port's checkpoints, restart supervisor and elastic restore against the
JAX package's (``repro.checkpoint``, ``repro.runtime.fault``,
``repro.runtime.elastic``), and the train launcher's checkpoint flags.

The manifest codec's bytes are msgpack's. Checkpoints cross between the
packages both ways, bitwise, with the same keys and dtype strings. The
supervisor runs the reference's ``test_supervisor_recovers_from_failures``
configuration (reduced smollm-135m, ``ShapeConfig("t", "train", 32, 2)``, 16
steps, a checkpoint every 4, failures at steps 6 and 11) beside the
reference's, with no mesh and on ``(data=8, model=1)``, where batch 2 is
replicated: the same executed steps, every loss within 1e-5. The reference
runs in one subprocess with 8 fake CPU devices on Auto meshes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.runtime import fault as ref_fault
from repro.runtime.elastic import scale_plan as ref_scale_plan
from repro_torch import bridge
from repro_torch.checkpoint import codec, latest_step, restore, save
from repro_torch.checkpoint.ckpt import host_arrays
from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig, TrainConfig, replace
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.launch.mesh import StackedMesh, make_production_mesh
from repro_torch.runtime.elastic import reshard_state, scale_plan
from repro_torch.runtime.fault import (FailureInjector, InjectedFailure, StragglerMonitor,
                                       TrainSupervisor)
from repro_torch.runtime.train_loop import init_state, make_train_step
from test_torch_support import (SMALL, SRC, flatten, one_torch_thread, random_tree,  # noqa: F401
                                run_reference)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPE = ShapeConfig("t", "train", 32, 2)
SUP_STEPS, SUP_EVERY, SUP_FAILS = 16, 4, (6, 11)
BF16 = replace(SMALL, param_dtype="bfloat16")


# ------------------------------------------------------------------- codec

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
VALUES = INTS + [
    *("s" * n for n in (0, 31, 32, 255, 256, 65535, 65536)), "é✓",
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    0.0, -0.0, 1.5, -2.25e300, float("inf"), True, False, None,
    [], list(range(15)), list(range(16)), list(range(65536)), (1, "a"),
    {}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {f"k{i}": i for i in range(65536)},
    {"a": {"b": [1, {"c": None, "d": b"x"}], "e": -7.5}, "dtypes": {"x/y": "bfloat16"}},
]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_codec_bytes_equal_msgpack(value):
    msgpack = pytest.importorskip("msgpack")
    want = msgpack.packb(value)
    assert codec.packb(value) == want
    assert codec.unpackb(want) == msgpack.unpackb(want)


def test_codec_rejects_what_msgpack_rejects():
    msgpack = pytest.importorskip("msgpack")
    for bad in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            msgpack.packb(bad)
        with pytest.raises(OverflowError):
            codec.packb(bad)
    with pytest.raises(TypeError):
        codec.packb({1j})
    with pytest.raises(ValueError, match="extra data"):
        codec.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb({1: 2}))   # msgpack's strict_map_key
    assert codec.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def test_codec_zlib_framing(monkeypatch):
    """Without zstandard the manifest is zlib (0x02); a zstd manifest then
    raises the reference's ImportError; zlib reads either way."""
    payload = codec.packb({"step": 3})
    monkeypatch.setattr(codec, "zstandard", None)
    blob = codec.compress_manifest(payload)
    assert blob[0] == codec.CODEC_ZLIB and codec.decompress_manifest(blob) == payload
    for first in (codec.CODEC_ZSTD, 0x28):
        with pytest.raises(ImportError, match="zstandard"):
            codec.decompress_manifest(bytes([first]) + b"\x00")
    with pytest.raises(ValueError, match="codec byte"):
        codec.decompress_manifest(b"\x07abc")
    with pytest.raises(ValueError, match="empty"):
        codec.decompress_manifest(b"")


# --------------------------------- ports of tests/test_checkpoint_fault.py


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                   "d": torch.tensor(3, dtype=torch.int32)}}
    save(state, str(tmp_path), 7)
    assert latest_step(str(tmp_path)) == 7
    restored, manifest = restore(str(tmp_path), 7, state)
    assert manifest["step"] == 7 and manifest["keys"] == ["a", "b/c", "b/d"]
    assert manifest["dtypes"] == {"a": "float32", "b/c": "bfloat16", "b/d": "int32"}
    for key in ("a", "b"):
        for want, got in zip(flatten({key: state[key]}).values(),
                             flatten({key: restored[key]}).values()):
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save({"a": torch.ones(2)}, str(tmp_path), 1)
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"a": torch.zeros(3)})


def test_checkpoint_missing_leaf_raises_key_error(tmp_path):
    save({"a": torch.ones(2)}, str(tmp_path), 1)
    with pytest.raises(KeyError, match="'b'"):
        restore(str(tmp_path), 1, {"a": torch.zeros(2), "b": torch.zeros(2)})


def test_latest_step_ignores_tmp(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    save({"a": torch.ones(2)}, str(tmp_path), 3)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 3


def test_async_checkpoint(tmp_path):
    """save() returns with every leaf on the host: a train step that updates
    the state in place right after does not reach the checkpoint."""
    state = init_state(RunConfig(model=SMALL, shape=SHAPE), StackedMesh(data=2, model=1),
                       random_tree(SMALL, 0), device="cpu")
    before = {k: a.copy() for k, (a, _) in host_arrays(state).items()}
    fut = save(state, str(tmp_path), 2, blocking=False)
    with torch.no_grad():
        for leaf in flatten(state.params).values():
            leaf.local.add_(1.0)
    fut.result()
    assert latest_step(str(tmp_path)) == 2
    restored, _ = restore(str(tmp_path), 2, state)
    for key, (a, _) in host_arrays(restored).items():
        np.testing.assert_array_equal(a, before[key], err_msg=key)


def test_straggler_monitor_matches_reference():
    """The same events as the reference's on one sequence of step times:
    slow steps, a recovery, and a drift upwards that the EMA follows."""
    dts = [0.1] * 10 + [1.0, 0.1, 0.1, 0.5, 0.35, 0.1] + [0.1 * 1.2 ** i for i in range(20)]
    for threshold in (2.0, 3.0):
        mon = StragglerMonitor(threshold=threshold)
        ref = ref_fault.StragglerMonitor(threshold=threshold)
        flags = [mon.observe(i, dt) for i, dt in enumerate(dts)]
        assert flags == [ref.observe(i, dt) for i, dt in enumerate(dts)]
        assert mon.events == ref.events and mon.ema == ref.ema and any(flags)


def test_failure_injector_fails_each_step_once():
    inj = FailureInjector(fail_at_steps=(2,))
    inj.check(1)
    with pytest.raises(InjectedFailure):
        inj.check(2)
    inj.check(2)


def test_scale_plan_matches_reference():
    for old in (1, 2, 4, 8):
        for new in (1, 2, 3, 4, 8, 16):
            for batch in (8, 16, 24, 48):
                if batch % old == 0:
                    assert scale_plan(old, new, batch) == ref_scale_plan(old, new, batch)


# ------------------------------------------------- the reference's side

_REF_BODY = f'''
import os
import jax.numpy as jnp
from repro.checkpoint import restore, save
from repro.checkpoint.ckpt import _decompress_manifest
from repro.configs import (MeshConfig, RunConfig, ShapeConfig, TrainConfig, get_model_config,
                           reduced, replace)
from repro.data import SyntheticPipeline
from repro.optim import adamw
from repro.runtime import init_state, make_train_step
from repro.runtime.fault import FailureInjector, TrainSupervisor
from repro.runtime.train_loop import TrainState, jit_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        OUT[prefix + key] = np.asarray(jnp.asarray(leaf, jnp.float32) if leaf.dtype == jnp.bfloat16
                                       else leaf)

def manifest_bytes(d, step):
    with open(os.path.join(d, f"step_{{step:08d}}", "manifest.msgpack.zst"), "rb") as f:
        return np.frombuffer(_decompress_manifest(f.read()), np.uint8)

class M24(MeshConfig):
    @property
    def shape(self): return (2, 4)
    @property
    def axes(self): return ("data", "model")

cfg = reduced(get_model_config("smollm-135m"))
bf16 = replace(cfg, param_dtype="bfloat16")

# the reference's bf16 init_state, saved with no mesh and on its (2, 4) mesh
state = init_state(RunConfig(model=bf16, shape=ShapeConfig("t", "train", 32, 8)), None,
                   jax.random.PRNGKey(0))
save(state, str(IN["ref_dir"]), 5)
put("ref_state/", state)
OUT["ref_manifest"] = manifest_bytes(str(IN["ref_dir"]), 5)
mesh24 = ref_mesh((2, 4), ("data", "model"))
run24 = RunConfig(model=bf16, shape=ShapeConfig("t", "train", 32, 8), mesh=M24())
state24 = init_state(run24, mesh24, jax.random.PRNGKey(1))
save(state24, str(IN["ref24_dir"]), 6)
put("ref24_state/", state24)

# the port's checkpoint, restored into the reference's structure
like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
restored, manifest = restore(str(IN["port_dir"]), 3, like)
put("port_restored/", restored)
OUT["port_restored_step"] = np.asarray(manifest["step"])

# the supervisor, test_supervisor_recovers_from_failures' configuration
shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
run = RunConfig(model=cfg, shape=shape, train=TrainConfig(steps=50))
pipe = SyntheticPipeline(cfg, shape)
for key, mesh in (("none", None), ("dp8", ref_mesh((8, 1), ("data", "model")))):
    if mesh is None:
        step = jax.jit(make_train_step(run, None)[2])
    else:
        step = jit_train_step(run, mesh)[1]
    for fails in (({", ".join(map(str, SUP_FAILS))},), ()):
        params = jax.tree.map(jnp.asarray, unflatten(IN, "params/"))
        sup = TrainSupervisor(step_fn=step, pipeline=pipe,
                              ckpt_dir=str(IN["sup_dir"]) + key + str(len(fails)),
                              ckpt_every={SUP_EVERY} if fails else 0,
                              injector=FailureInjector(fail_at_steps=fails), async_ckpt=False)
        final, hist = sup.run(TrainState(params, adamw.init(params)), {SUP_STEPS})
        at = f"sup/{{key}}/{{'fail' if fails else 'free'}}/"
        OUT[at + "steps"] = np.asarray([h["step"] for h in hist])
        OUT[at + "loss"] = np.asarray([h["loss"] for h in hist])
        OUT[at + "opt_step"] = np.asarray(final.opt.step)
'''


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The port's bf16 state on (data=4, model=2), saved; then the
    reference's subprocess: its own checkpoints, its restore of the port's,
    and its supervisor runs."""
    tmp = tmp_path_factory.mktemp("ckpt")
    dirs = {name: str(tmp / name) for name in ("port_dir", "ref_dir", "ref24_dir", "sup_dir")}
    tree = random_tree(SMALL, 3)
    mesh = StackedMesh(data=4, model=2)
    run = RunConfig(model=BF16, shape=ShapeConfig("t", "train", 32, 8))
    port_state = init_state(run, mesh, tree, device="cpu")
    save(port_state, dirs["port_dir"], 3)
    inputs = {"params/" + k: v for k, v in flatten(random_tree(SMALL, 4)).items()}
    inputs.update({k: np.asarray(v) for k, v in dirs.items()})
    ref = run_reference(_REF_BODY, inputs)
    return dirs, port_state, mesh, inputs, ref


def _like(mesh, mesh_cfg=MeshConfig(), cfg=BF16):
    """The port's train state of ``cfg`` on ``mesh``: the structure to restore into."""
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 8), mesh=mesh_cfg)
    return init_state(run, mesh, bridge.random_params(cfg, 9), device="cpu")


def _f32(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.view(np.uint16).astype(np.uint32).__lshift__(16).view(np.float32) \
        if dtype == "bfloat16" else a


def _manifest(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.msgpack.zst"), "rb") as f:
        return codec.unpackb(codec.decompress_manifest(f.read()))


def test_reference_manifest_through_codec(case):
    """The reference's own manifest: the codec reads it as msgpack does and
    packs what it read back to the same bytes."""
    msgpack = pytest.importorskip("msgpack")
    raw = case[4]["ref_manifest"].tobytes()
    assert codec.unpackb(raw) == msgpack.unpackb(raw)
    assert codec.packb(codec.unpackb(raw)) == raw
    dirs = case[0]
    with open(os.path.join(dirs["ref_dir"], "step_00000005", "manifest.msgpack.zst"), "rb") as f:
        assert codec.unpackb(codec.decompress_manifest(f.read())) == msgpack.unpackb(raw)


def test_reference_checkpoint_restores_in_port(case):
    """The reference's bf16 init_state, saved with no mesh, restored into
    ``(data=4, model=2)``: every array bitwise, the same keys and dtype
    strings as the port's own checkpoint of that structure."""
    dirs, _, mesh, _, ref = case
    restored, manifest = restore(dirs["ref_dir"], 5, _like(mesh), mesh=None)
    assert isinstance(restored.opt.step, int) and restored.opt.step == 0
    assert restored.params["blocks"]["attn"]["wq"].local.shape[0] == mesh.n_ranks
    got = host_arrays(restored)
    assert list(got) == manifest["keys"]
    assert {k: d for k, (_, d) in got.items()} == manifest["dtypes"]
    for key, (a, dtype) in got.items():
        np.testing.assert_array_equal(_f32(a, dtype), ref["ref_state/" + key], err_msg=key)
    port = _manifest(dirs["port_dir"], 3)
    assert port["keys"] == manifest["keys"] and port["dtypes"] == manifest["dtypes"]


def test_reference_mesh_checkpoint_restores_in_port(case):
    """A checkpoint that the reference wrote from its (2, 4) mesh restores
    into the port's ``(data=4, model=2)``, bitwise."""
    dirs, _, mesh, _, ref = case
    restored, manifest = restore(dirs["ref24_dir"], 6, _like(StackedMesh(data=2, model=4)),
                                 mesh=mesh, mesh_cfg=MeshConfig())
    assert manifest["step"] == 6
    assert restored.params["embed"].local.shape[0] == mesh.n_ranks
    for key, (a, dtype) in host_arrays(restored).items():
        np.testing.assert_array_equal(_f32(a, dtype), ref["ref24_state/" + key], err_msg=key)


def test_port_checkpoint_restores_in_reference(case):
    """The port's bf16 state, saved from ``(data=4, model=2)``, restored by
    the reference's ``restore``: every array bitwise, the step int32."""
    _, port_state, _, _, ref = case
    assert int(ref["port_restored_step"]) == 3
    for key, (a, dtype) in host_arrays(port_state).items():
        np.testing.assert_array_equal(ref["port_restored/" + key], _f32(a, dtype), err_msg=key)
    assert ref["port_restored/opt/step"].dtype == np.int32


def _supervise(tree, mesh, fails, ckpt_dir, async_ckpt=False):
    run = RunConfig(model=SMALL, shape=SHAPE, train=TrainConfig(steps=50))
    _, ctx, step = make_train_step(run, mesh, device="cpu")
    sup = TrainSupervisor(step_fn=step, pipeline=SyntheticPipeline(SMALL, SHAPE, device="cpu"),
                          ckpt_dir=ckpt_dir, ckpt_every=SUP_EVERY if fails else 0,
                          injector=FailureInjector(fail_at_steps=fails), async_ckpt=async_ckpt)
    final, hist = sup.run(init_state(run, mesh, tree, device="cpu"), SUP_STEPS)
    return ctx, final, hist


@pytest.mark.parametrize("key,mesh", [("none", None), ("dp8", StackedMesh(data=8, model=1))],
                         ids=["none", "dp8"])
def test_supervisor_matches_reference(case, tmp_path, key, mesh):
    """Failures at 6 and 11 restart from the checkpoints of 4 and 8: the
    reference's executed steps, every loss within 1e-5 of its; the final
    loss equals a failure-free port run's."""
    _, _, _, inputs, ref = case
    tree = {k[len("params/"):]: v for k, v in inputs.items() if k.startswith("params/")}
    tree = _nest(tree)
    ctx, final, hist = _supervise(tree, mesh, SUP_FAILS, str(tmp_path / "a"))
    assert ctx.shard_batch == (mesh is None)
    steps = [h["step"] for h in hist]
    assert steps == ref[f"sup/{key}/fail/steps"].tolist()
    assert steps[-1] == SUP_STEPS - 1 and steps.count(4) == 2 and steps.count(8) == 2
    np.testing.assert_allclose([h["loss"] for h in hist], ref[f"sup/{key}/fail/loss"], atol=1e-5,
                               rtol=0)
    assert final.opt.step == int(ref[f"sup/{key}/fail/opt_step"]) == SUP_STEPS
    _, final2, hist2 = _supervise(tree, mesh, (), str(tmp_path / "b"))
    np.testing.assert_allclose([h["loss"] for h in hist2], ref[f"sup/{key}/free/loss"], atol=1e-5,
                               rtol=0)
    assert hist[-1]["loss"] == hist2[-1]["loss"]
    assert not os.path.exists(tmp_path / "b")


def test_async_supervisor_equals_sync(case, tmp_path):
    """With async saves the restart point is still the last save made: the
    same executed steps and bits as with blocking saves."""
    tree = _nest({k[len("params/"):]: v for k, v in case[3].items() if k.startswith("params/")})
    mesh = StackedMesh(data=2, model=1)
    _, a, hist_a = _supervise(tree, mesh, SUP_FAILS, str(tmp_path / "sync"))
    _, b, hist_b = _supervise(tree, mesh, SUP_FAILS, str(tmp_path / "async"), async_ckpt=True)
    assert [(h["step"], h["loss"]) for h in hist_a] == [(h["step"], h["loss"]) for h in hist_b]
    for (ka, (xa, _)), (kb, (xb, _)) in zip(host_arrays(a).items(), host_arrays(b).items()):
        assert ka == kb
        np.testing.assert_array_equal(xa, xb, err_msg=ka)
    assert latest_step(str(tmp_path / "async")) == SUP_STEPS


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    run = RunConfig(model=SMALL, shape=SHAPE)
    _, _, step = make_train_step(run, None, device="cpu")
    sup = TrainSupervisor(step_fn=step, pipeline=SyntheticPipeline(SMALL, SHAPE, device="cpu"),
                          ckpt_dir=str(tmp_path), ckpt_every=1, max_restarts=1,
                          injector=FailureInjector(fail_at_steps=(1, 2)), async_ckpt=False)
    with pytest.raises(InjectedFailure, match="step 2"):
        sup.run(init_state(run, None, random_tree(SMALL, 0), device="cpu"), 4)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


# --------------------------------------------------------------- elastic


@pytest.mark.parametrize("axes,multi_pod", [({"data": 4, "model": 2}, False),
                                            ({"pod": 2, "data": 2, "model": 2}, True)],
                         ids=["dp4", "pod"])
def test_elastic_restore_into_other_mesh(tmp_path, axes, multi_pod):
    """A state trained a step on ``(data=2, model=4)``, restored from its
    checkpoint into another mesh and moved there by ``reshard_state``:
    every array bitwise, split for the new mesh; the next step there
    within the training limits of the step on the old mesh."""
    tree = random_tree(SMALL, 6)
    old, new = StackedMesh(data=2, model=4), StackedMesh(**axes)
    cfg_new = MeshConfig(multi_pod=multi_pod)
    shape = ShapeConfig("t", "train", 32, 8)
    run_old = RunConfig(model=SMALL, shape=shape)
    run_new = run_old.replace(mesh=cfg_new)
    pipe = SyntheticPipeline(SMALL, shape, device="cpu")
    _, _, step_old = make_train_step(run_old, old, device="cpu")
    state, _ = step_old(init_state(run_old, old, tree, device="cpu"), pipe.next_batch(0))
    save(state, str(tmp_path), 1)
    saved = host_arrays(state)
    restored, _ = restore(str(tmp_path), 1, state, mesh=new, mesh_cfg=cfg_new)
    moved = reshard_state(state, run_new, new)
    for got in (restored, moved):
        assert got.params["blocks"]["attn"]["wq"].local.shape[0] == new.n_ranks
        assert got.params["blocks"]["attn"]["wq"].local.requires_grad
        assert got.opt.step == 1
        for key, (a, _) in host_arrays(got).items():
            np.testing.assert_array_equal(a, saved[key][0], err_msg=key)
    _, _, step_new = make_train_step(run_new, new, device="cpu")
    _, m_new = step_new(restored, pipe.next_batch(1))
    _, m_old = step_old(state, pipe.next_batch(1))
    assert float(m_new["loss"]) == pytest.approx(float(m_old["loss"]), rel=1e-5)
    assert float(m_new["grad_norm"]) == pytest.approx(float(m_old["grad_norm"]), rel=1e-4)


def test_restore_rejects_a_mesh_without_the_dp_axes(tmp_path):
    state = _like(StackedMesh(data=2, model=1), cfg=SMALL)
    save(state, str(tmp_path), 1)
    with pytest.raises(ValueError, match="dp axes"):
        restore(str(tmp_path), 1, state, mesh=StackedMesh(pod=2, data=2, model=1),
                mesh_cfg=MeshConfig())


# ---------------------------------------------------------------- launchers


def test_train_launcher_checkpoints(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--seq", "32"])
    out = capsys.readouterr().out
    assert "[train] done; stragglers flagged: " in out and "step     2 loss" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    assert latest_step(str(tmp_path)) == 2


def test_train_launcher_production_mesh(tmp_path, capsys):
    """--mesh production --multi-pod stacks 512 ranks; batch 2 is replicated."""
    from repro_torch.launch import train
    train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "1",
                "--mesh", "production", "--multi-pod", "--batch", "2", "--seq", "8",
                "--fsdp-mode", "mcast",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "StackedMesh(pod=2, data=16, model=16)" in out and "step     0 loss" in out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_train_launcher_production_mesh_families(arch, tmp_path, capsys):
    """--mesh production (data=16, model=16) trains the MoE, rwkv, hybrid and
    encdec families with their leaves split over ``model`` where they
    divide (whisper's heads, the reduced MoE's 8 experts and rwkv's 4 heads
    do not at tp = 16, and run whole on every tp rank): the losses and grad
    norms it prints are the ``(8, 1)`` local mesh's."""
    from repro_torch.launch import train

    def losses(mesh: str) -> list[str]:
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--log-every", "1", "--mesh", mesh, "--batch", "2", "--seq", "8",
                    "--fsdp-mode", "mcast", "--ckpt-dir", str(tmp_path / mesh)])
        out = capsys.readouterr().out
        return [line.split(" dt ")[0] for line in out.splitlines() if line.startswith("step")]

    prod = losses("production")
    assert len(prod) == 2
    assert prod == losses("local")


def test_production_mesh_ranks():
    assert make_production_mesh().n_ranks == 256
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).n_ranks == 512
    assert make_production_mesh(multi_pod=True).rank_axes == ("pod", "data", "model")
    assert make_production_mesh(multi_pod=True).dp_rank_axes == ("pod", "data")


def test_serve_launcher_default_batch(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--fsdp-mode", "mcast"])
    assert "4 seqs, 8 prompt + 3 new tokens" in capsys.readouterr().out


# ------------------------------------------------------------ no msgpack


@pytest.mark.parametrize("blocked", [("msgpack",), ("msgpack", "zstandard")],
                         ids=["no_msgpack", "no_msgpack_no_zstd"])
def test_port_checkpoints_without_msgpack(tmp_path, blocked):
    """In a process where ``msgpack`` (and zstandard) cannot be imported, the
    port saves and restores a train state bitwise, loading no jax and
    nothing of the JAX package; without zstandard the manifest is zlib."""
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch import bridge\n"
        "from repro_torch.checkpoint import latest_step, restore, save\n"
        "from repro_torch.checkpoint.ckpt import host_arrays\n"
        "from repro_torch.configs import RunConfig, ShapeConfig, get_model_config, reduced\n"
        "from repro_torch.launch.mesh import StackedMesh\n"
        "from repro_torch.runtime.train_loop import init_state\n"
        "cfg = reduced(get_model_config('smollm-135m'))\n"
        "run = RunConfig(model=cfg, shape=ShapeConfig('t', 'train', 16, 8))\n"
        "mesh = StackedMesh(data=8, model=1)\n"
        "state = init_state(run, mesh, bridge.random_params(cfg, 0), device='cpu')\n"
        f"d = {str(tmp_path)!r}\n"
        "save(state, d, 4, blocking=False).result()\n"
        "assert latest_step(d) == 4\n"
        "back, manifest = restore(d, 4, state)\n"
        "for (k, (a, _)), (_, (b, _)) in zip(host_arrays(state).items(),\n"
        "                                    host_arrays(back).items()):\n"
        "    assert np.array_equal(a, b), k\n"
        "from repro_torch.checkpoint import codec\n"
        "assert codec.zstandard is None or 'zstandard' not in sys.argv[1:]\n"
        "first = open(d + '/step_00000004/manifest.msgpack.zst', 'rb').read()[0]\n"
        "assert first == (codec.CODEC_ZSTD if codec.zstandard else codec.CODEC_ZLIB), first\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert sys.modules['msgpack'] is None\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code, *blocked], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]

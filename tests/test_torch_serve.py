"""The port's serving path against the JAX package's, end to end: reduced
smollm-135m in f32 on a (data=8, model=1) mesh, batch 8, a 32-token prompt.

The reference runs ``jit_prefill_step`` / ``jit_decode_step`` in a subprocess
with 8 fake CPU devices on an Auto mesh. Tolerances: prefill logits and KV
cache 1e-5 abs (f32 sums in another order); decode logits 1e-4 abs (the
error of 8 further steps through the same sums).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import bridge
from repro_torch.configs import MeshConfig
from repro_torch.kernels import ring_allgather as K
from repro_torch.launch.mesh import StackedMesh
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.sharding.ctx import use_ctx
from test_torch_support import SMALL, flatten, random_tree, run_reference, serve_run

MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
B, S, NEW = 8, 32, 9   # NEW - 1 = 8 decode steps after the prefill

_BODY = f'''
import jax.numpy as jnp
from repro.configs import CollectiveConfig, RunConfig, ShapeConfig, get_model_config, reduced
from repro.models import build_model
from repro.runtime.serve_loop import ServeState, greedy_generate, jit_decode_step, jit_prefill_step
cfg = reduced(get_model_config("smollm-135m"))
mesh = ref_mesh((8, 1), ("data", "model"))
params = unflatten(IN, "params/")
tokens = IN["tokens"]
for mode in {MODES}:
    run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                    collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
    _, step = jit_prefill_step(run, mesh)
    logits, cache = step(params, {{"tokens": tokens}})
    OUT[mode + "/logits"] = np.asarray(logits)
    OUT[mode + "/k"], OUT[mode + "/v"] = np.asarray(cache["k"]), np.asarray(cache["v"])
run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + NEW}, {B}))
_, dec = jit_decode_step(run, mesh)
cache = {{n: np.pad(OUT["xla/" + n], [(0, 0)] * 3 + [(0, {NEW}), (0, 0)]) for n in "kv"}}
state = ServeState(cache, np.full(({B},), {S}, np.int32))
tok = np.argmax(OUT["xla/logits"], -1).astype(np.int32)
toks, lgs = [tok], []
for _ in range({NEW - 1}):
    lg, state = dec(params, state, tok)
    tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
    lgs.append(np.asarray(lg))
    toks.append(tok)
OUT["decode/logits"], OUT["decode/tokens"] = np.stack(lgs), np.stack(toks, 1)
api = build_model(cfg)
OUT["greedy"] = np.asarray(greedy_generate(api, params, jnp.asarray(tokens), {NEW}, {S + NEW}))
OUT["hidden"] = np.asarray(api.forward_fn(params, {{"tokens": tokens}}))
'''


@pytest.fixture(scope="module")
def case():
    tree = random_tree(SMALL, 0)
    tokens = np.random.default_rng(7).integers(0, SMALL.vocab_size, (B, S)).astype(np.int32)
    inputs = {"params/" + k: v for k, v in flatten(tree).items()}
    inputs["tokens"] = tokens
    ref = run_reference(_BODY, inputs)
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    return mesh, params, torch.from_numpy(tokens).long(), ref


def _prefill(case, mode):
    mesh, params, tokens, _ = case
    _, _, prefill = make_prefill_step(serve_run(SMALL, mode, B, S), mesh, device="cpu")
    return prefill(params, {"tokens": tokens})


def _close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_matches_jax(case, mode):
    ref = case[3]
    logits, cache = _prefill(case, mode)
    assert logits.shape == (B, SMALL.vocab_size)
    _close(logits, ref[mode + "/logits"], 1e-5)
    _close(cache["k"], ref[mode + "/k"], 1e-5)
    _close(cache["v"], ref[mode + "/v"], 1e-5)


def test_modes_agree_bitwise(case):
    """The gathers are exact copies, so every mode computes the same bits."""
    outs = {m: _prefill(case, m) for m in MODES}
    for m in MODES[1:]:
        assert torch.equal(outs[m][0], outs["xla"][0]), m
        for n in ("k", "v"):
            assert torch.equal(outs[m][1][n], outs["xla"][1][n]), (m, n)


def test_decode_matches_jax(case):
    """8 decode steps from the prefill's cache: same greedy tokens as the
    reference's jit_decode_step, logits within 1e-4."""
    mesh, params, _, ref = case
    logits, cache = _prefill(case, "xla")
    _, _, decode = make_decode_step(serve_run(SMALL, "mcast", B, S + NEW, "decode"), mesh,
                                    device="cpu")
    state = ServeState({n: F.pad(c, (0, 0, 0, NEW)) for n, c in cache.items()},
                       torch.full((B,), S, dtype=torch.long))
    tok = logits.argmax(-1)
    toks, lgs = [tok], []
    for _ in range(NEW - 1):
        lg, state = decode(params, state, tok)
        tok = lg.argmax(-1)
        lgs.append(lg)
        toks.append(tok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), ref["decode/tokens"])
    _close(torch.stack(lgs), ref["decode/logits"], 1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_greedy_generate_matches_reference(case, mode):
    """Prefill through the mode's gather, then greedy decode: the reference's
    tokens, both its decode-step path and its token-by-token greedy_generate."""
    mesh, params, tokens, ref = case
    run = serve_run(SMALL, mode, B, S)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    before = (K.launches, K.allgather_launches)
    out = greedy_generate(prefill, decode, params, tokens, NEW, S + NEW)
    assert (K.launches, K.allgather_launches) == before   # CPU: the plain ring steps
    assert torch.equal(out[:, :S], tokens)
    np.testing.assert_array_equal(out[:, S:].numpy(), ref["decode/tokens"])
    np.testing.assert_array_equal(out.numpy(), ref["greedy"])


def test_forward_matches_jax(case):
    mesh, params, tokens, ref = case
    run = serve_run(SMALL, "mcast_ring", B, S)
    api, ctx, _ = make_prefill_step(run, mesh, device="cpu")
    with use_ctx(ctx):
        hidden = api.forward_fn(params, {"tokens": tokens})
    _close(hidden, ref["hidden"], 1e-5)

"""The registry's other dense configs in the port (yi-9b, granite-3-8b,
granite-34b) against the JAX package's, reduced and in f32: the configs and
their parameter counts, serving on an Auto ``(data=8, model=1)`` mesh in
every mode, and 3 training steps on an Auto ``(data=2, model=4)`` mesh in
every mode. A fourth case, reduced granite-3-8b with an odd tied vocab of
259, stands for the full model's 49,155: its head's backward products take
the matmul's wmma path (``collective_matmul.path``), which a spy on the CPU
counts.

The reduced configs keep what the full ones have: yi-9b's untied 64,000-row
head and GQA (2 kv heads, 4 query heads here), granite-3-8b's tied head,
granite-34b's MQA (one kv head) and GELU MLP (``w_in`` / ``w_out``) with an
untied head.

The reference runs in one subprocess with 8 fake CPU devices
(``run_reference``), started first; the port's runs go on beside it.
Tolerances: prefill logits and KV cache within 1e-5, decode logits within
1e-4, the same tokens; training loss within 1e-5 and grad_norm within 1e-4,
relative, parameters within 1e-5, every mode of the port against the
reference's ``xla`` mode (the reference's own modes agree within 1e-6 in
loss and 1e-5 in grad_norm, tests/test_train_integration.py:83-84), and the
port's first-step loss bitwise equal across its modes.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.configs.registry import arch_names as ref_arch_names
from repro.models.model_builder import count_params_analytic as ref_count
from repro_torch import bridge
from repro_torch.configs import (SHAPES, CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                                 TrainConfig, arch_names, get_model_config, get_shape, reduced,
                                 replace, training_sweep_archs)
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels import collective_matmul as M
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import count_params_analytic, make_dummy_batch
from repro_torch.runtime.serve_loop import (ServeState, greedy_generate, make_decode_step,
                                            make_prefill_step)
from repro_torch.runtime.train_loop import init_state, make_train_step
from repro_torch.sharding.fsdp import at_use
from test_torch_support import (flatten, one_torch_thread,  # noqa: F401
                                random_tree, run_reference, serve_run)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NEW_ARCHS = ("yi-9b", "granite-3-8b", "granite-34b")
# case: (arch, vocab override)
CASES = {"yi-9b": ("yi-9b", None), "granite-3-8b": ("granite-3-8b", None),
         "granite-34b": ("granite-34b", None), "granite-3-8b-v259": ("granite-3-8b", 259)}
MODES = ["xla", "mcast", "mcast_ring", "mcast_bcast"]
B, S, NEW = 8, 32, 9            # serving: NEW - 1 = 8 decode steps after the prefill
SHAPE = ShapeConfig("t", "train", 64, 4)
STEPS = 3


def case_cfg(case: str):
    arch, vocab = CASES[case]
    cfg = reduced(get_model_config(arch))
    return cfg if vocab is None else replace(cfg, vocab_size=vocab)


def _tokens(case: str) -> np.ndarray:
    seed = list(CASES).index(case)
    return np.random.default_rng(seed).integers(0, case_cfg(case).vocab_size,
                                                (B, S)).astype(np.int32)


_BODY = f'''
import jax.numpy as jnp
from repro.configs import (CollectiveConfig, MeshConfig, RunConfig, ShapeConfig,
                           TrainConfig, get_model_config, reduced, replace)
from repro.data import SyntheticPipeline
from repro.optim import adamw
from repro.runtime.serve_loop import ServeState, jit_decode_step, jit_prefill_step
from repro.runtime.train_loop import TrainState, jit_train_step

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        OUT[prefix + "/".join(k.key for k in path)] = np.asarray(leaf)

class SmallMesh(MeshConfig):
    @property
    def shape(self): return (2, 4)
    @property
    def axes(self): return ("data", "model")

for case, (arch, vocab) in {CASES}.items():
    cfg = reduced(get_model_config(arch))
    if vocab is not None:
        cfg = replace(cfg, vocab_size=vocab)
    # serving on (8, 1)
    mesh = ref_mesh((8, 1), ("data", "model"))
    params = jax.tree.map(jnp.asarray, unflatten(IN, case + "/serve/"))
    tokens = IN[case + "/tokens"]
    for mode in {MODES}:
        run = RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", {S}, {B}),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, step = jit_prefill_step(run, mesh)
        logits, cache = step(params, {{"tokens": tokens}})
        OUT[f"{{case}}/{{mode}}/logits"] = np.asarray(logits)
        OUT[f"{{case}}/{{mode}}/k"] = np.asarray(cache["k"])
        OUT[f"{{case}}/{{mode}}/v"] = np.asarray(cache["v"])
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", {S + NEW}, {B}))
    _, dec = jit_decode_step(run, mesh)
    cache = {{n: np.pad(OUT[f"{{case}}/xla/{{n}}"], [(0, 0)] * 3 + [(0, {NEW}), (0, 0)])
             for n in "kv"}}
    state = ServeState(cache, np.full(({B},), {S}, np.int32))
    tok = np.argmax(OUT[f"{{case}}/xla/logits"], -1).astype(np.int32)
    toks, lgs = [tok], []
    for _ in range({NEW - 1}):
        lg, state = dec(params, state, tok)
        tok = np.asarray(jnp.argmax(lg, -1).astype(jnp.int32))
        lgs.append(np.asarray(lg))
        toks.append(tok)
    OUT[case + "/decode/logits"], OUT[case + "/decode/tokens"] = np.stack(lgs), np.stack(toks, 1)

    # training on (2, 4), the xla mode
    mesh = ref_mesh((2, 4), ("data", "model"))
    shape = ShapeConfig("t", "train", {SHAPE.seq_len}, {SHAPE.global_batch})
    pipe = SyntheticPipeline(cfg, shape)
    run = RunConfig(model=cfg, shape=shape, mesh=SmallMesh(), train=TrainConfig(steps=5),
                    collective=CollectiveConfig(fsdp_mode="xla", n_chains=2))
    _, jstep = jit_train_step(run, mesh)
    params = jax.tree.map(jnp.asarray, unflatten(IN, case + "/train/"))
    state = TrainState(params, adamw.init(params))
    for i in range({STEPS}):
        state, m = jstep(state, pipe.next_batch(i))
        for name in ("loss", "grad_norm"):
            OUT[f"{{case}}/{{name}}{{i}}"] = np.asarray(m[name])
    put(case + "/params/", state.params)
'''


def _port_serving(case: str, tree) -> dict:
    cfg = case_cfg(case)
    mesh = StackedMesh(data=8, model=1)
    params = bridge.to_torch(tree, mesh, MeshConfig(), dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(_tokens(case)).long()
    out = {}
    for mode in MODES:
        run = serve_run(cfg, mode, B, S)
        _, _, prefill = make_prefill_step(run, mesh, device="cpu")
        _, _, dec = make_decode_step(run, mesh, device="cpu")
        out[mode] = prefill(params, {"tokens": tokens})
        out[mode + "/greedy"] = greedy_generate(prefill, dec, params, tokens, NEW, S + NEW)
    logits, cache = out["xla"]
    _, _, decode = make_decode_step(serve_run(cfg, "mcast", B, S + NEW, "decode"), mesh,
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
    out["decode"] = (torch.stack(lgs), torch.stack(toks, 1))
    return out


def _port_training(case: str, tree) -> dict:
    cfg = case_cfg(case)
    mesh = StackedMesh(data=2, model=4)
    out = {}
    for mode in MODES:
        run = RunConfig(model=cfg, shape=SHAPE, train=TrainConfig(steps=5),
                        collective=CollectiveConfig(fsdp_mode=mode, n_chains=2))
        _, _, step = make_train_step(run, mesh, device="cpu")
        state = init_state(run, mesh, tree, device="cpu")
        pipe = SyntheticPipeline(cfg, SHAPE, device="cpu")
        metrics = []
        for i in range(STEPS):
            state, m = step(state, pipe.next_batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
        params = flatten(bridge.to_numpy(at_use(state.params, mesh.n_ranks, ("data",)), mesh,
                                         MeshConfig()))
        out[mode] = (metrics, params)
    return out


@pytest.fixture(scope="module")
def case():
    """The reference's serving and training of every case in one
    subprocess, started first; the port's runs beside it."""
    trees = {c: (random_tree(case_cfg(c), 10 + i), random_tree(case_cfg(c), 20 + i))
             for i, c in enumerate(CASES)}
    inputs = {}
    for c, (serve_tree, train_tree) in trees.items():
        inputs.update({f"{c}/serve/{k}": v for k, v in flatten(serve_tree).items()})
        inputs.update({f"{c}/train/{k}": v for k, v in flatten(train_tree).items()})
        inputs[c + "/tokens"] = _tokens(c)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_reference, _BODY, inputs)
        port = {c: dict(serve=_port_serving(c, trees[c][0]), train=_port_training(c, trees[c][1]))
                for c in CASES}
        return dict(ref=ref.result(), port=port)


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(case, name, mode):
    ref = case["ref"]
    cfg = case_cfg(name)
    logits, cache = case["port"][name]["serve"][mode]
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref[f"{name}/{mode}/logits"], atol=1e-5, rtol=0)
    for n in ("k", "v"):
        assert cache[n].shape == (cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        np.testing.assert_allclose(cache[n].numpy(), ref[f"{name}/{mode}/{n}"], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_and_greedy_match_jax(case, name):
    """8 decode steps from the xla prefill's cache: the reference's tokens,
    logits within 1e-4; greedy generation in every mode gives those tokens."""
    ref, port = case["ref"], case["port"][name]["serve"]
    lgs, toks = port["decode"]
    np.testing.assert_array_equal(toks.numpy(), ref[name + "/decode/tokens"])
    np.testing.assert_allclose(lgs.numpy(), ref[name + "/decode/logits"], atol=1e-4, rtol=0)
    tokens = _tokens(name)
    for mode in MODES:
        out = port[mode + "/greedy"]
        np.testing.assert_array_equal(out[:, :S].numpy(), tokens)
        np.testing.assert_array_equal(out[:, S:].numpy(), ref[name + "/decode/tokens"],
                                      err_msg=mode)


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_match_jax(case, name, mode):
    """3 steps: loss within 1e-5, grad_norm within 1e-4, relative, then every
    parameter within 1e-5 of the reference's."""
    ref = case["ref"]
    metrics, params = case["port"][name]["train"][mode]
    for i, m in enumerate(metrics):
        assert m["loss"] == pytest.approx(float(ref[f"{name}/loss{i}"]), rel=1e-5), i
        assert m["grad_norm"] == pytest.approx(float(ref[f"{name}/grad_norm{i}"]), rel=1e-4), i
    for key, a in params.items():
        np.testing.assert_allclose(a, ref[f"{name}/params/{key}"], atol=1e-5, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_train_modes_agree_bitwise_on_the_first_loss(case, name):
    first = {mode: run[0][0]["loss"] for mode, run in case["port"][name]["train"].items()}
    assert len(set(first.values())) == 1, first


# -------------------------------------------------- the odd vocab's head


def _paths(fn) -> list[tuple]:
    """(path, x shape, w shape) of every product that ``fn`` runs on the
    CPU, from a spy on ``collective_matmul.matmul`` (the plain version runs)."""
    seen = []
    orig = M.matmul

    def spy(x, w, **kw):
        seen.append((M.path(x, w), tuple(x.shape), tuple(w.shape)))
        return orig(x, w, **kw)

    M.matmul = spy
    try:
        fn()
    finally:
        M.matmul = orig
    return seen


@pytest.mark.parametrize("vocab,chunks", [(259, 1), (256, 1), (49155, 2)])
def test_odd_tied_vocab_head_takes_wmma(vocab, chunks):
    """bf16: every rank's copy of the head is (D, V) with V of unit stride
    (the tied embedding's gather is laid out so, as the untied head is), so
    at an odd vocab V its rows are 2V bytes apart, which TMA cannot take,
    and so is the logits' cotangent (rows, V). Every head product then goes
    to the wmma kernel: in training the forward and the checkpointed
    recompute of each cross-entropy chunk and its two backward products
    (dx = dy embed, dW = x^T dy), 4 a chunk; in serving one a prefill and
    one a decode step. Every other product takes wgmma, and an even vocab
    keeps the head on wgmma too. Two chunks at 1,024 tokens a rank."""
    cfg = replace(reduced(get_model_config("granite-3-8b"), layers=1), vocab_size=vocab,
                  param_dtype="bfloat16", compute_dtype="bfloat16")
    mesh = StackedMesh(data=2, model=1)
    shape = ShapeConfig("t", "train", 512 * chunks, 2)
    run = RunConfig(model=cfg, shape=shape, collective=CollectiveConfig(fsdp_mode="mcast"))
    _, _, step = make_train_step(run, mesh, device="cpu")
    state = init_state(run, mesh, bridge.random_params(cfg, 0), device="cpu")
    batch = SyntheticPipeline(cfg, shape, device="cpu").next_batch(0)
    train = _paths(lambda: step(state, batch))
    params = bridge.to_torch(bridge.random_params(cfg, 0), mesh, MeshConfig(),
                             dtype=torch.bfloat16, device="cpu")
    run = serve_run(cfg, "mcast", 2, 8)
    _, _, prefill = make_prefill_step(run, mesh, device="cpu")
    _, _, decode = make_decode_step(run, mesh, device="cpu")
    tokens = torch.zeros(2, 8, dtype=torch.long)
    serve = _paths(lambda: greedy_generate(prefill, decode, params, tokens, 2, 10))
    odd = bool(vocab % 8)
    for seen, want in ((train, 4 * chunks), (serve, 2)):
        assert all(p in ("wgmma", "wmma") for p, *_ in seen), seen
        wmma = [s for s in seen if s[0] == "wmma"]
        assert len(wmma) == (want if odd else 0), wmma
        assert all(vocab in (*xs[1:], *ws[1:]) for _, xs, ws in wmma), wmma
        heads = [s for s in seen if vocab in (*s[1][1:], *s[2][1:])]
        assert len(heads) == want


# ------------------------------------------------------ configs and counts


def _ref_cfg(name):
    return ref_model_config(name)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_reference(arch):
    got, want = get_model_config(arch), _ref_cfg(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(ref_reduced(want))


def test_registry_holds_the_dense_configs():
    assert set(NEW_ARCHS) <= set(arch_names())
    assert set(arch_names()) == set(ref_arch_names())
    assert training_sweep_archs() == ("smollm-135m", "yi-9b", "granite-34b")
    for name in SHAPES:
        assert get_shape(name) == SHAPES[name]
    with pytest.raises(KeyError):
        get_shape("train_1m")
    with pytest.raises(KeyError):
        get_model_config("whisper-large")


def _uncounted(cfg) -> int:
    """Weights of the tree that the reference's analytic count leaves out:
    the norm scales of a dense or MoE tree; the final norm of an rwkv one
    (its blocks' norms are counted); a hybrid's final norm, its norms
    outside the rec block and its unused one-layer ``tail_rec`` where the
    depth has no trailing layer, less the count's one vector of lru_width
    too many a rec layer."""
    d = cfg.d_model
    if cfg.family in ("dense", "moe", "vlm"):
        return cfg.num_layers * 2 * d + d
    if cfg.family == "encdec":
        return cfg.encdec.enc_layers * 2 * d + cfg.encdec.dec_layers * 3 * d + 2 * d
    if cfg.family == "rwkv":
        return d
    ng, nt = divmod(cfg.num_layers, len(cfg.rglru.pattern))
    w, recs = cfg.rglru.lru_width, 2 * ng + nt
    rec = 2 * d * w + cfg.rglru.conv_width * w + 2 * w * w + w * d + 4 * w + 2 * d \
        + 3 * d * cfg.d_ff
    return d + recs * (d - w) + 2 * ng * d + (rec if nt == 0 else 0)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b", *NEW_ARCHS, "rwkv6-7b",
                                  "recurrentgemma-9b", "phi-3-vision-4.2b", "whisper-base",
                                  "moonshot-v1-16b-a3b"])
def test_param_counts_equal_reference(arch):
    """``count_params_analytic`` with and without ``active_only`` and the
    config's ``n_params`` / ``n_active_params``: the reference's, full and
    reduced; MoE's active count takes top_k routed experts."""
    for got_cfg, want_cfg in ((get_model_config(arch), _ref_cfg(arch)),
                              (reduced(get_model_config(arch)), ref_reduced(_ref_cfg(arch)))):
        for active in (False, True):
            assert count_params_analytic(got_cfg, active_only=active) == \
                ref_count(want_cfg, active_only=active)
        assert got_cfg.n_params() == want_cfg.n_params()
        assert got_cfg.n_active_params() == want_cfg.n_active_params()
        if got_cfg.family == "moe":
            assert got_cfg.n_active_params() < got_cfg.n_params()
        else:
            assert got_cfg.n_active_params() == got_cfg.n_params()
    # the reduced tree's weights, less what the count leaves out, are that count
    cfg = reduced(get_model_config(arch))
    assert sum(a.size for a in flatten(bridge.random_params(cfg, 0)).values()) \
        - _uncounted(cfg) == cfg.n_params()


def test_full_sizes():
    """The parameter counts the card runs: yi-9b 8.83 B, granite-3-8b 8.17 B,
    granite-34b 33.96 B (15.77 B at the 40 layers it is served at)."""
    assert get_model_config("yi-9b").n_params() == 8_829_009_920
    assert get_model_config("granite-3-8b").n_params() == 8_170_516_480
    g34 = get_model_config("granite-34b")
    assert g34.n_params() == 33_961_279_488
    assert replace(g34, num_layers=40).n_params() == 15_766_388_736


def test_make_dummy_batch():
    """``make_dummy_batch``: every input of ``batch_dims``, token ids in
    range from the generator (the same ids from the same seed), positions 0."""
    cfg = case_cfg("granite-3-8b-v259")
    for kind, want in (("train", {"tokens": (4, 16), "targets": (4, 16)}),
                       ("prefill", {"tokens": (4, 16)}), ("decode", {"token": (4,), "pos": (4,)})):
        shape = ShapeConfig("s", kind, 16, 4)
        a = make_dummy_batch(cfg, shape, torch.Generator().manual_seed(1), device="cpu")
        b = make_dummy_batch(cfg, shape, torch.Generator().manual_seed(1), device="cpu")
        assert {k: tuple(v.shape) for k, v in a.items()} == want
        for k, v in a.items():
            assert v.dtype == torch.long and torch.equal(v, b[k])
            if k == "pos":
                assert not v.any()
            else:
                assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_dummy_batch(cfg, ShapeConfig("s", "prefill", 8, 2), torch.Generator())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_launchers_take_the_new_archs(arch, tmp_path, capsys):
    from repro_torch.launch import serve, train
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--new-tokens", "3", "--fsdp-mode", "mcast"])
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
                "--seq", "32", "--fsdp-mode", "mcast_bcast", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "1", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu" in out and "8 prompt + 3 new tokens" in out
    assert "step     1 loss" in out


def test_chip_smoke_expected_paths_match_the_predicate():
    """``chip_smoke.expected_path``, which phase 1 asserts, names the kernel
    that ``collective_matmul.path`` picks for every product of the dense
    configs' prefill, decode and 2-layer training at full width (operands
    on the meta device: layouts, no data), and ``head_wmma`` the odd
    vocab's head products of ``matmul_cases``."""
    import importlib.util
    import os
    from test_torch_support import REPO
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def meta(r, rows, cols, t, dtype):
        if t:
            return torch.empty((r, cols, rows), device="meta", dtype=dtype).transpose(1, 2)
        return torch.empty((r, rows, cols), device="meta", dtype=dtype)

    for arch in (*NEW_ARCHS, "smollm-135m"):
        for cfg, m, head_m, train in ((cs._dense_cfg(arch, train=True), 1024, None, True),
                                      (cs._dense_cfg(arch), 128, 1, False),
                                      (cs._dense_cfg(arch), 1, None, False)):
            cases = cs.matmul_cases(cfg, 8, m, torch.bfloat16, train=train, head_m=head_m)
            wmma = 0
            for case, count in cases.items():
                r, mm, k, n, a_t, b_t, dt = case
                got = M.path(meta(r, mm, k, a_t, dt), meta(r, k, n, b_t, dt))
                assert got == cs.expected_path(*case), (arch, case)
                wmma += count if got == "wmma" else 0
            assert wmma == cs.head_wmma(cfg, train=train), (arch, train)
            assert (wmma > 0) == (arch == "granite-3-8b")

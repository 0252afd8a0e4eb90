"""The port's layers and attention against the JAX package's, in f32 on the
same numpy inputs (the reference in-process on one CPU device). Weighted
layers take a leading rank dim in the port; rank 0 is compared.

Tolerance: atol 1e-5, f32 sums taken in a different order by XLA and torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as ref_model_config
from repro.configs import reduced as ref_reduced
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.models import attention, layers
from test_torch_support import SMALL

ATOL = 1e-5
RNG = np.random.default_rng(0)


def _randn(*shape, scale=1.0):
    return (scale * RNG.standard_normal(shape)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_rms_norm():
    x, w = _randn(2, 5, 64), _randn(64, scale=0.1)
    got = layers.rms_norm(torch.from_numpy(x)[None], torch.from_numpy(w)[None], 1e-5)
    _close(got[0], ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("name", ["gelu", "silu", "relu_sq"])
def test_activation(name):
    x = _randn(3, 17)
    _close(layers.activation(name, torch.from_numpy(x)),
           ref_layers.activation(name, jnp.asarray(x)))


@pytest.mark.parametrize("pos_shape", [(1, 7), (2, 7)])
def test_apply_rope(pos_shape):
    x = _randn(2, 7, 4, 16)
    pos = RNG.integers(0, 100, pos_shape).astype(np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(got, ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def test_mlp_apply_swiglu():
    p = {"w_gate": _randn(64, 128, scale=0.125), "w_up": _randn(64, 128, scale=0.125),
         "w_down": _randn(128, 64, scale=0.09)}
    x = _randn(2, 5, 64)
    got = layers.mlp_apply({k: torch.from_numpy(v)[None] for k, v in p.items()},
                           torch.from_numpy(x)[None], "swiglu")
    want = ref_layers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), "swiglu")
    _close(got[0], want)


def _attn_params():
    d, h, kv, hd = SMALL.d_model, SMALL.num_heads, SMALL.num_kv_heads, SMALL.head_dim
    return {"wq": _randn(d, h * hd, scale=d ** -0.5), "wk": _randn(d, kv * hd, scale=d ** -0.5),
            "wv": _randn(d, kv * hd, scale=d ** -0.5), "wo": _randn(h * hd, d, scale=0.1)}


def test_qkv_split_and_out_proj():
    p = _attn_params()
    ref_cfg = ref_reduced(ref_model_config("smollm-135m"))
    x = _randn(2, 5, SMALL.d_model)
    pt = {k: torch.from_numpy(v)[None] for k, v in p.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    got = layers.qkv_split(pt, torch.from_numpy(x)[None], SMALL)
    want = ref_layers.qkv_split(pj, jnp.asarray(x), ref_cfg)
    for g, w in zip(got, want):
        _close(g[0], w)
    o = _randn(2, 5, SMALL.num_heads, SMALL.head_dim)
    _close(layers.out_proj(pt, torch.from_numpy(o)[None])[0],
           ref_layers.out_proj(pj, jnp.asarray(o)))


@pytest.mark.parametrize("s,q_block,kv_block,window", [
    (24, 32, 16, None),    # chunked branch (s <= q_block), padded KV block
    (80, 32, 16, None),    # q-blocked branch, padded last q block
    (80, 32, 16, 24),      # q-blocked with a sliding window
])
def test_blockwise_attention(s, q_block, kv_block, window):
    q, k, v = _randn(2, s, 4, 16), _randn(2, s, 2, 16), _randn(2, s, 2, 16)
    kw = dict(causal=True, window=window, q_block=q_block, kv_block=kv_block)
    got = attention.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    _close(got, ref_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw))


def test_plain_decode_attention():
    q, kc, vc = _randn(4, 4, 16), _randn(4, 2, 20, 16), _randn(4, 2, 20, 16)
    pos = np.array([0, 5, 13, 19], dtype=np.int32)
    got = attention.plain_decode_attention(*map(torch.from_numpy, (q, kc, vc, pos)))
    _close(got, ref_attn.plain_decode_attention(*map(jnp.asarray, (q, kc, vc, pos))))


def test_cache_scatter_update():
    cache, new = _randn(4, 2, 10, 16), _randn(4, 2, 16)
    pos = np.array([0, 3, 9, 10], dtype=np.int32)   # 10 is out of range: dropped
    got = attention.cache_scatter_update(torch.from_numpy(cache.copy()),
                                         torch.from_numpy(new), torch.from_numpy(pos))
    want = ref_attn.cache_scatter_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

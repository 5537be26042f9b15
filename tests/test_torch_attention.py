"""Port parity: the PyTorch plain attention (the plain versions of the
flash and decode CUDA kernels, and their CPU dispatch) against the JAX
package's jnp attention and its Pallas kernels in interpret mode, in
fp32 within atol 2e-5. Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as jax_decode_kernel
from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash_kernel
from repro.models import attention as jax_attn
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention as pt_attn

torch.set_num_threads(1)
ATOL = 2e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


# (B, S, H, K, D, block) — MHA-free GQA and MQA; S a block multiple,
# as the JAX Pallas kernel asserts
@pytest.mark.parametrize("B,S,H,K,D,blk", [(2, 64, 4, 2, 16, 32),
                                           (1, 32, 4, 1, 8, 16)])
def test_port_causal_attention_matches_jax(B, S, H, K, D, blk):
    rng = np.random.default_rng(S + H)
    q, k, v = _rand(rng, B, S, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_jnp = jax_attn.causal_attention(jq, jk, jv, chunk=blk)
    want_pallas = jax_flash_kernel(jq, jk, jv, bq=blk, bk=blk,
                                   interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (pt_attn.causal_attention(tq, tk, tv),
                attention(tq, tk, tv), flash_attention_ref(tq, tk, tv)):
        assert got.shape == (B, S, H, D) and got.dtype == torch.float32
        _close(got, want_jnp)
        _close(got, want_pallas)


def test_port_decode_attention_matches_jax():
    B, S, H, K, D, bs = 3, 32, 4, 2, 16, 16
    rng = np.random.default_rng(7)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    lengths = np.array([5, 16, 32], np.int32)   # ragged, tile-aligned, full
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(lengths))
    want_jnp = jax_attn.decode_attention(jargs[0][:, None], *jargs[1:])[:, 0]
    want_pallas = jax_decode_kernel(*jargs, bs=bs, interpret=True)
    targs = tuple(torch.from_numpy(x) for x in (q, kc, vc, lengths))
    got_model = pt_attn.decode_attention(targs[0][:, None], *targs[1:])
    assert got_model.shape == (B, 1, H, D)
    for got in (got_model[:, 0], decode_attention(*targs),
                decode_attention_ref(*targs)):
        assert got.shape == (B, H, D)
        _close(got, want_jnp)
        _close(got, want_pallas)


# GQA groups the CUDA kernel takes since it carries head tiles: G = 16
# (GLM-4-9B, one full m16 tile) and 5 (Llama-4-Scout)
@pytest.mark.parametrize("G", [16, 5])
def test_port_decode_gqa_groups_match_jax(G):
    B, S, K, D = 2, 32, 2, 16
    H = K * G
    rng = np.random.default_rng(G)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    lengths = np.array([9, 32], np.int32)
    want = jax_attn.decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths))[:, 0]
    targs = tuple(torch.from_numpy(x) for x in (q, kc, vc, lengths))
    for got in (decode_attention(*targs), decode_attention_ref(*targs),
                decode_attention_split_ref(*targs, dec_kernel.CHUNK)):
        assert got.shape == (B, H, D)
        _close(got, want)
    # the kernel's head tile: the group rounded up, or tiles of the most
    # a block carries
    bf16, fp32 = (dec_kernel.heads_per_block(G, t)
                  for t in (torch.bfloat16, torch.float32))
    assert (bf16, fp32) == {16: (16, 8), 5: (8, 8)}[G]


# lengths with empty trailing chunks at every chunk size, a full cache,
# and 0; the chunk sizes include 1, a ragged 7, the kernel's 32 and 64,
# and one past S
@pytest.mark.parametrize("chunk", [1, 7, 16, 32, 64])
def test_port_decode_split_ref_matches_jax(chunk):
    B, S, H, K, D = 6, 48, 4, 2, 16
    rng = np.random.default_rng(chunk)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    lengths = np.array([0, 1, 5, 17, 48, 31], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(lengths))
    want_jnp = np.asarray(jax_attn.decode_attention(jargs[0][:, None],
                                                    *jargs[1:])[:, 0])
    want_pallas = np.asarray(jax_decode_kernel(*jargs, bs=16,
                                               interpret=True))
    got = decode_attention_split_ref(
        *(torch.from_numpy(x) for x in (q, kc, vc, lengths)), chunk)
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    live = lengths > 0
    _close(got[live], want_jnp[live])
    _close(got[live], want_pallas[live])
    # length 0 attends to nothing: 0 (JAX's jnp twin averages the whole
    # cache there, its Pallas kernel divides 0 by 0)
    assert not live.all() and float(got[~live].abs().max()) == 0.0


def test_port_decode_length_zero_gives_zero():
    """Every plain decode path gives 0 for a sequence of length 0 and
    leaves the other rows as JAX computes them."""
    B, S, H, K, D = 3, 32, 4, 2, 16
    rng = np.random.default_rng(11)
    q, kc, vc = _rand(rng, B, H, D), _rand(rng, B, S, K, D), \
        _rand(rng, B, S, K, D)
    lengths = np.array([7, 0, 32], np.int32)
    want = np.asarray(jax_attn.decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths))[:, 0])
    targs = tuple(torch.from_numpy(x) for x in (q, kc, vc, lengths))
    for got in (pt_attn.decode_attention(targs[0][:, None],
                                         *targs[1:])[:, 0],
                decode_attention(*targs), decode_attention_ref(*targs),
                decode_attention_split_ref(*targs, 16)):
        assert float(got[1].abs().max()) == 0.0
        _close(got[[0, 2]], want[[0, 2]])


def test_port_decode_masks_past_length():
    """Garbage past ``lengths`` must not change the output."""
    rng = np.random.default_rng(3)
    B, S, H, K, D = 2, 16, 2, 2, 8
    q = torch.from_numpy(_rand(rng, B, H, D))
    kc, vc = (torch.from_numpy(_rand(rng, B, S, K, D)) for _ in range(2))
    lens = torch.tensor([5, 16], dtype=torch.int32)
    pos = torch.arange(S)[None, :, None, None]
    keep = pos < lens[:, None, None, None]
    out = decode_attention(q, kc, vc, lens)
    out2 = decode_attention(q, torch.where(keep, kc, 123.0),
                            torch.where(keep, vc, -55.0), lens)
    assert float((out - out2).abs().max()) < 1e-6


def test_attention_kernel_wrappers_take_cuda_tensors_only():
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    f0, d0 = flash_kernel.launches, dec_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, kv, kv)
    assert torch.equal(attention(q, kv, kv),
                       pt_attn.causal_attention(q, kv, kv))
    with pytest.raises(ValueError, match="CUDA"):
        dec_kernel.decode_attention(q[:, 0], kv, kv,
                                    torch.ones(1, dtype=torch.int32))
    assert (flash_kernel.launches, dec_kernel.launches) == (f0, d0)

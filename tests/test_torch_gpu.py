"""Card-only tests: each hand-written CUDA kernel of the port against its
plain PyTorch version, and the model on the card against the same
weights on the CPU. They skip without a CUDA card (a CUDA kernel has no
CPU mode); ``chip_smoke.py`` holds the same comparisons at the serving
path's full shapes. On the card: ``python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.simsearch import kernel as ss_kernel
from repro_torch.kernels.simsearch.ref import simsearch_ref
from repro_torch.models import attention as plain
from repro_torch.models import transformer as tr

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided per test (never at import, so every pytest
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("B,N,d,k", [(5, 1000, 64, 8), (40, 3000, 64, 1),
                                     (3, 130, 8, 3), (16, 512, 128, 32)])
def test_simsearch_kernel_matches_plain(cuda, B, N, d, k):
    g = torch.Generator(device=cuda).manual_seed(B + N)
    q, c = _randn(g, B, d), _randn(g, N, d)
    before = ss_kernel.launches
    v, i = ss_kernel.simsearch(q, c, k)
    vr, ir = simsearch_ref(q, c, k)
    torch.cuda.synchronize()
    # one launch per chunk of MAX_QUERIES query rows (B=40 is two)
    assert ss_kernel.launches == before + -(-B // ss_kernel.MAX_QUERIES)
    assert torch.equal(i, ir)
    assert float((v - vr).abs().max()) <= 1e-5


def test_simsearch_kernel_ties_go_to_lowest_index(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = _randn(g, 5000, 64)
    c[4000] = c[9]
    c[2500] = c[9]
    _, i = ss_kernel.simsearch(c[9:10].clone(), c, 3)
    assert i[0].tolist() == [9, 2500, 4000]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,K,D", [(8, 40, 16, 8, 128), (1, 1000, 16, 8,
                                                             128),
                                       (2, 33, 8, 2, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, S, H, K, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(g, B, S, H, D, dtype=dtype)
    k, v = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    out = flash_kernel.flash_attention(q, k, v)
    ref = plain.causal_attention(q.float(), k.float(), v.float())
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_kernel_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S, K, G, D = 8, 512, 8, 2, 128
    q = _randn(g, B, K * G, D, dtype=dtype)
    kc, vc = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    lens = torch.tensor([1, 31, 32, 33, 200, 256, 511, 512],
                        dtype=torch.int32, device=cuda)
    out = dec_kernel.decode_attention(q, kc, vc, lens)
    ref = plain.decode_attention(q.float()[:, None], kc.float(), vc.float(),
                                 lens)[:, 0]
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= tol


def test_model_on_card_matches_cpu(cuda):
    """Same fp32 weights: the card (kernels) against the CPU (plain)."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32",
                              head_dim=64)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = {"layers": {k: v.to(cuda)
                             for k, v in params["layers"].items()},
                  **{k: v.to(cuda) for k, v in params.items()
                     if k != "layers"}}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 259, size=(2, 19))).long()
    lc, cc = tr.prefill(cfg, params, toks, max_len=32)
    lg, cg = tr.prefill(cfg, params_gpu, toks.to(cuda), max_len=32)
    assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
    tok = torch.argmax(lc, -1)
    for _ in range(3):
        lc, cc = tr.decode_step(cfg, params, cc, tok)
        lg, cg = tr.decode_step(cfg, params_gpu, cg, tok.to(cuda))
        assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
        tok = torch.argmax(lc, -1)

"""Port parity: the PyTorch transformer and LLMEngine against the JAX
model on the ``qwen3-1.7b`` smoke config in fp32, with the JAX weights
carried across by ``params_from_numpy``. Prefill logits and the KV cache
within atol/rtol 2e-4; four greedy decode steps give identical tokens;
``generate_batch`` gives identical text."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as jtr
from repro.serving.engine import LLMEngine as JaxEngine
from repro_torch.configs import (CARD_HEAD_DIM, get_arch, smoke_config,
                                  smoke_config_for)
from repro_torch.models import transformer as ptr
from repro_torch.serving.engine import BatchingFrontend, LLMEngine

torch.set_num_threads(1)
TOL = 2e-4


PROMPTS = ["how do i fix my bike", "hey how do i sell my laptop"]
MAX_LEN = 48


@pytest.fixture(scope="module")
def models():
    """The JAX engine's own jitted prefill/decode serve both tests, at
    the one token shape ``generate_batch`` gives PROMPTS: two compiles."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-1.7b"),
                               dtype="float32")
    pcfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32")
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    jeng = JaxEngine(jcfg, params=jparams, max_len=MAX_LEN)
    return jeng, pcfg, ptr.params_from_numpy(pcfg, tree, "cpu")


def test_config_copy_matches_jax():
    from repro.configs import get_arch as jax_get_arch
    for name in ("qwen3-1.7b", "glm4-9b", "minitron-8b", "qwen2-moe-a2.7b",
                 "llama4-scout-17b-a16e"):
        a, b = jax_get_arch(name), get_arch(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
    assert dataclasses.asdict(jax_smoke_config("qwen3-1.7b")) == \
        dataclasses.asdict(smoke_config("qwen3-1.7b"))


@pytest.mark.parametrize("name", ["qwen3-1.7b", "glm4-9b",
                                  "minitron-8b", "qwen2-moe-a2.7b",
                                  "llama4-scout-17b-a16e", "wide-deep"])
def test_smoke_config_for_the_card_differs_only_in_head_dim(name):
    """The launcher's config: on the CPU the JAX package's smoke config;
    on CUDA the same with head dim 64 for an LM (recsys unchanged)."""
    want = dataclasses.asdict(jax_smoke_config(name))
    assert dataclasses.asdict(smoke_config_for(name, "cpu")) == want
    card = dataclasses.asdict(smoke_config_for(name, "cuda"))
    if "head_dim" in want:
        assert card.pop("head_dim") == CARD_HEAD_DIM != want.pop("head_dim")
    assert card == want


def test_prefill_and_greedy_decode_match_jax(models):
    jeng, pcfg, pparams = models
    in_len = max(len(p.encode()) + 2 for p in PROMPTS)
    toks = np.stack([jeng.tok.encode(p, max_len=in_len) for p in PROMPTS])
    j_logits, j_cache = jeng._prefill(jeng.params, jnp.asarray(toks))
    p_logits, p_cache = ptr.prefill(pcfg, pparams,
                                    torch.from_numpy(toks).long(),
                                    max_len=MAX_LEN)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                               atol=TOL, rtol=TOL)
    for f in ("k", "v"):
        assert p_cache[f].shape == j_cache[f].shape
        np.testing.assert_allclose(p_cache[f].numpy(),
                                   np.asarray(j_cache[f]), atol=TOL,
                                   rtol=TOL)
    assert np.array_equal(p_cache["length"].numpy(),
                          np.asarray(j_cache["length"]))

    j_tok = np.asarray(jnp.argmax(j_logits, -1), np.int32)
    p_tok = torch.argmax(p_logits, -1)
    for step in range(4):
        assert np.array_equal(p_tok.numpy(), j_tok), step
        j_logits, j_cache = jeng._decode(jeng.params, j_cache,
                                         jnp.asarray(j_tok))
        p_logits, p_cache = ptr.decode_step(pcfg, pparams, p_cache, p_tok)
        np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits),
                                   atol=TOL, rtol=TOL)
        j_tok = np.asarray(jnp.argmax(j_logits, -1), np.int32)
        p_tok = torch.argmax(p_logits, -1)
    np.testing.assert_allclose(p_cache["k"].numpy(), np.asarray(j_cache["k"]),
                               atol=TOL, rtol=TOL)


def test_engine_generate_batch_matches_jax(models):
    jeng, pcfg, pparams = models
    want = jeng.generate_batch(PROMPTS, max_new_tokens=4)
    eng = LLMEngine(pcfg, params=pparams, max_len=MAX_LEN, device="cpu")
    assert eng.generate_batch(PROMPTS, max_new_tokens=4) == want
    assert eng.stats.batches == 1 and eng.stats.prefills == 2
    front = BatchingFrontend(eng, max_batch=2, max_new_tokens=4)
    try:
        assert front.submit_many(PROMPTS) == want
    finally:
        front.stop()


def test_engine_failure_reaches_the_router(models):
    """A failed engine batch fails the requests behind it: the router
    counts the error and nothing is cached, so the next request for the
    same prompt goes to the backend again."""
    from repro_torch.launch.serve import build_service

    _, pcfg, pparams = models
    service = build_service(pcfg, device="cpu", params=pparams,
                            max_len=MAX_LEN, max_new_tokens=4)
    prompt = "what is the boiling point of tin"
    try:
        def broken(prompts, max_new_tokens=32):
            raise RuntimeError("kernel launch failed")
        service.engine.generate_batch = broken
        assert service.router.submit(prompt) is None
        assert service.frontend.failed_batches == 1
        stats = service.router.stats()
        assert stats["errors"] == 1 and "engine batch failed" \
            in stats["last_error"]
        del service.engine.generate_batch
        r = service.router.submit(prompt)
        assert r.served_by == "backend"
        assert r.answer == service.engine.generate(prompt, 4)
        assert service.frontend.failed_batches == 1
    finally:
        service.stop()


def test_engine_random_init_is_seeded_and_bf16_by_default():
    cfg = smoke_config("qwen3-1.7b")
    a = LLMEngine(cfg, seed=3, max_len=32, device="cpu")
    b = LLMEngine(cfg, seed=3, max_len=32, device="cpu")
    assert a.params["embed"].dtype == torch.bfloat16
    assert torch.equal(a.params["layers"]["wq"], b.params["layers"]["wq"])
    w = a.params["layers"]["wq"].float()
    assert float(w.abs().max()) <= 3.0 * cfg.d_model ** -0.5 + 1e-2
    out = a.generate_batch(["hello"], max_new_tokens=2)
    assert out == b.generate_batch(["hello"], max_new_tokens=2)


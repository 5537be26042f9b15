"""Port parity for the engine's ``temperature=``: the port's Gumbel-max
sampler against ``repro.serving.engine.LLMEngine._sample`` on the same
fp32 logits and the same noise (the reference draws it from numpy's
global generator: ``np.random.seed`` before the JAX call, the same array
injected into the port), and a smoke-config engine generating under the
reference's noise on both sides. At temperature 0 the port stays the
greedy argmax bit for bit and draws nothing. The port's own noise
(``LLMEngine.gumbel``, from its generator) is checked for its moments,
its edge draws and the frequencies it gives against ``softmax(l / T)``.

While the engine test runs, every thread of this process is held to one
core (as in ``test_torch_moe.py``): the JAX engine's jitted prefill and
decode are whole-program compiles."""
import dataclasses
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as jtr
from repro.serving.engine import LLMEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as ptr
from repro_torch.serving.engine import LLMEngine

torch.set_num_threads(1)
PROMPTS = ["how do i fix my bike", "hey how do i sell my laptop"]
MAX_LEN = 48
NEW_TOKENS = 16
NEAR_TIE = 1e-5
VOCAB = 151_936            # Qwen3-1.7B's vocabulary


def _pin(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:                 # the thread ended meanwhile
            pass


@pytest.fixture(scope="module")
def engine():
    """A port engine on the CPU (smoke config, its own random weights):
    the sampler tests set its ``temperature``."""
    return LLMEngine(smoke_config("qwen3-1.7b"), max_len=MAX_LEN, seed=0,
                     device="cpu")


def _jax_sample(T, logits: np.ndarray, seed: int) -> np.ndarray:
    """The reference's ``_sample`` at temperature T, its noise from
    numpy's global generator seeded by ``seed``."""
    np.random.seed(seed)
    return JaxEngine._sample(types.SimpleNamespace(temperature=T),
                             jnp.asarray(logits))


def _sample_with(engine, logits: np.ndarray, g: np.ndarray) -> np.ndarray:
    """``engine._sample`` on ``logits`` with ``g`` injected as its noise
    (in place of :meth:`LLMEngine.gumbel`'s draw)."""
    engine.gumbel = lambda shape: torch.from_numpy(g)
    try:
        return engine._sample(torch.from_numpy(logits))
    finally:
        del engine.gumbel


def test_sample_matches_jax_on_the_same_noise(engine):
    rng = np.random.default_rng(0)
    for B, V, scale in ((8, VOCAB, 2.0), (3, 1000, 8.0), (5, 256, 0.1)):
        logits = (rng.standard_normal((B, V)) * scale).astype(np.float32)
        for T in (0.05, 0.3, 0.7, 1.0, 1.7):
            engine.temperature = T
            for seed in (0, 1):
                want = _jax_sample(T, logits, seed)
                np.random.seed(seed)
                g = np.random.gumbel(size=logits.shape)
                got = _sample_with(engine, logits, g)
                assert got.dtype == np.int32 and np.array_equal(got, want), \
                    (B, V, T, seed)
    # ties in the noisy scores go to the first index, as jnp.argmax's
    engine.temperature = 0.5
    logits = np.zeros((2, 12), np.float32)
    logits[:, [3, 7]] = 1.0
    g = np.zeros((2, 12))
    g[1, 3] = -1.0
    got = _sample_with(engine, logits, g)
    want = np.asarray(jnp.argmax(jnp.asarray(logits) / 0.5 + g, -1))
    assert got.tolist() == want.tolist() == [3, 7]


def test_temperature_zero_is_the_greedy_argmax(engine):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((8, VOCAB)) * 3).astype(np.float32)
    logits[0, [10, 20]] = logits[0].max() + 1     # a planted tie
    state = engine._noise_gen.get_state()
    for T in (0.0, -1.0):
        engine.temperature = T
        got = engine._sample(torch.from_numpy(logits))
        assert np.array_equal(
            got, torch.argmax(torch.from_numpy(logits), -1).numpy())
        assert np.array_equal(got, _jax_sample(T, logits, 0))
        assert got[0] == 10
    # the greedy path draws no noise
    assert torch.equal(engine._noise_gen.get_state(), state)


@pytest.fixture(scope="module")
def models():
    """The JAX engine (its own jitted prefill and decode, at the one
    token shape PROMPTS give) and the port's engine over the same fp32
    weights, both at temperature 0.7; held to one core meanwhile."""
    cores = os.sched_getaffinity(0)
    _pin({min(cores)})
    try:
        jcfg = dataclasses.replace(jax_smoke_config("qwen3-1.7b"),
                                   dtype="float32")
        pcfg = dataclasses.replace(smoke_config("qwen3-1.7b"),
                                   dtype="float32")
        jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        jeng = JaxEngine(jcfg, params=jparams, max_len=MAX_LEN,
                         temperature=0.7)
        peng = LLMEngine(pcfg, params=ptr.params_from_numpy(pcfg, tree,
                                                            "cpu"),
                         max_len=MAX_LEN, temperature=0.7, device="cpu")
        yield jeng, peng
    finally:
        _pin(cores)


def _recorded(engine, attr, record):
    """Wrap ``engine.<attr>`` (``_sample`` or ``gumbel``) in an instance
    attribute that appends what each call saw or made to ``record``."""
    orig = getattr(engine, attr)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        record.append((np.asarray(a[0]), out) if attr == "_sample"
                      else out)
        return out
    setattr(engine, attr, wrapped)


def test_engine_generates_as_jax_under_the_reference_noise(models):
    """Both engines generate NEW_TOKENS tokens for PROMPTS at T 0.7 with
    numpy's global generator seeded alike, the port fed the same draws
    (float64 -> fp32, as JAX casts them in the add). Identical texts,
    unless a row's first differing token is a near tie of the reference's
    noisy scores (its top two within NEAR_TIE), which is counted."""
    jeng, peng = models
    j_steps, p_steps, p_noise = [], [], []
    _recorded(jeng, "_sample", j_steps)
    _recorded(peng, "_sample", p_steps)
    peng.gumbel = lambda shape: torch.from_numpy(
        np.random.gumbel(size=tuple(shape)))
    _recorded(peng, "gumbel", p_noise)
    near_ties = 0
    try:
        for seed in (0, 1, 2):
            for rec in (j_steps, p_steps, p_noise):
                rec.clear()
            np.random.seed(seed)
            want = jeng.generate_batch(PROMPTS, NEW_TOKENS)
            np.random.seed(seed)
            got = peng.generate_batch(PROMPTS, NEW_TOKENS)
            assert len(p_steps) == len(p_noise) > 1
            for b in range(len(PROMPTS)):
                # the sampled ids step by step (texts drop the ids past
                # the byte range)
                step = next((k for k, ((_, jt), (_, pt)) in
                             enumerate(zip(j_steps, p_steps))
                             if jt[b] != pt[b]), None)
                if step is None:
                    assert got[b] == want[b], (seed, b)
                    continue
                scores = j_steps[step][0][b] / np.float32(0.7) \
                    + p_noise[step][b].numpy().astype(np.float32)
                top2 = np.sort(scores)[-2:]
                assert top2[1] - top2[0] <= NEAR_TIE, \
                    (seed, b, step, got[b], want[b])
                near_ties += 1
            if not near_ties:
                assert len(p_steps) == len(j_steps)
        print(f"near-tie divergences: {near_ties} of "
              f"{3 * len(PROMPTS)} sequences")
    finally:
        del jeng._sample, peng._sample, peng.gumbel
    # the greedy path of the same engines: identical, and no draw
    jeng.temperature = peng.temperature = 0.0
    try:
        state = peng._noise_gen.get_state()
        assert peng.generate_batch(PROMPTS, NEW_TOKENS) == \
            jeng.generate_batch(PROMPTS, NEW_TOKENS)
        assert torch.equal(peng._noise_gen.get_state(), state)
    finally:
        jeng.temperature = peng.temperature = 0.7


def test_gumbel_draws_moments_and_edges(engine, monkeypatch):
    """2^20 draws: finite, mean within 6 standard errors of Euler's
    gamma (SE = (pi^2/6)^0.5 / 2^10 = 1.25e-3) and variance within 6 of
    pi^2/6 (SE = (pi^2/6) (4.4 / 2^20)^0.5 = 3.4e-3: the Gumbel's
    excess kurtosis is 2.4). A draw of E = 0 gives a finite score: the
    argmax stays the logits' own, never NaN or a stray +inf winner."""
    n = 2 ** 20
    g = engine.gumbel((n,)).double()
    assert g.dtype == torch.float64 and bool(g.isfinite().all())
    var = math.pi ** 2 / 6
    assert abs(float(g.mean()) - 0.5772156649) <= 6 * var ** 0.5 / 2 ** 10
    assert abs(float(g.var()) - var) <= 6 * var * (4.4 / n) ** 0.5
    # the same seed gives the same draws, another seed others
    a = LLMEngine(engine.cfg, params=engine.params, seed=5,
                  device="cpu").gumbel((4, 9))
    b = LLMEngine(engine.cfg, params=engine.params, seed=5,
                  device="cpu").gumbel((4, 9))
    c = LLMEngine(engine.cfg, params=engine.params, seed=6,
                  device="cpu").gumbel((4, 9))
    assert torch.equal(a, b) and not torch.equal(a, c)
    monkeypatch.setattr(torch.Tensor, "exponential_",
                        lambda self, generator=None: self.fill_(0.0))
    edge = engine.gumbel((3, 5))
    assert bool(edge.isfinite().all()) and float(edge.max()) < 88
    engine.temperature = 0.7
    logits = torch.tensor([[0.0, 2.0, 1.0, 2.0]] * 3)
    assert engine._sample(logits).tolist() == [1, 1, 1]


def test_sampled_frequencies_match_softmax(engine):
    """One fp32 logits row of 64 drawn N = 2^18 times at T 0.7: the
    total variation between the sample frequencies and softmax(l / T)
    stays within E[TV] <= sum_i sqrt(p_i (1 - p_i) / N) / 2 plus the
    McDiarmid deviation sqrt(ln(1e6) / (2 N)) (exceeded with probability
    below 1e-6 by a correct sampler)."""
    engine.temperature = 0.7
    rng = np.random.default_rng(3)
    row = torch.from_numpy((rng.standard_normal(64) * 1.5)
                           .astype(np.float32))
    N = 2 ** 18
    counts = np.zeros(64)
    for _ in range(N // 4096):
        counts += np.bincount(engine._sample(row.expand(4096, 64)),
                              minlength=64)
    p = torch.softmax(row.double() / 0.7, -1).numpy()
    tv = 0.5 * np.abs(counts / N - p).sum()
    bound = 0.5 * np.sqrt(p * (1 - p) / N).sum() \
        + math.sqrt(math.log(1e6) / (2 * N))
    assert tv <= bound, (tv, bound)

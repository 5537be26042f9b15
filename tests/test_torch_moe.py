"""Port parity: MoE serving (``models/moe.py`` and the transformer's MoE
branch) against the JAX package on the CPU, at the smoke configs of
``qwen2-moe-a2.7b`` (top-2 of 4 experts, one shared expert) and
``llama4-scout-17b-a16e`` (top-1, one shared expert, GQA group 4). Inputs
are made with numpy from a seed; weights are JAX's ``init_params``,
carried across by ``params_from_numpy``. The ``moe`` functions of the
JAX package run eagerly, the model through ``JaxEngine``'s own jitted
prefill and decode.

Comparisons:
- the config copies (``asdict``, parameter counts, smoke configs);
- ``capacity`` over a grid, exactly;
- ``router_topk`` and ``load_balance_loss`` at atol/rtol 1e-5, expert
  ids identical; planted ties go to the lowest index, as JAX's
  ``top_k`` does (``torch.topk`` does not);
- ``moe_ffn_sort`` (``n_groups`` halved until it divides T, and one
  group with a router biased to one expert, so that the later slots in
  stable order are dropped) and ``moe_ffn_einsum``, with and without the
  shared expert: outputs and aux at 1e-5, expert ids and kept slots
  identical to the reference's rule applied to JAX's ids;
- ``init_params`` against ``jax.eval_shape`` of JAX's (names, shapes,
  dtypes);
- prefill logits and the KV cache at 2e-4, four greedy decode steps
  with identical tokens, ``generate_batch`` text identical;
- the launcher with ``--arch qwen2-moe-a2.7b --device cpu``.

An expert id that differs where JAX's k-th and (k+1)-th probabilities
lie within 1e-6 is counted and reported, not failed (there are none
with these seeds)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jm
from repro.models import transformer as jtr
from repro.serving.engine import LLMEngine as JaxEngine
from repro_torch.configs import get_arch, smoke_config, smoke_config_for
from repro_torch.models import moe as pm
from repro_torch.models import transformer as ptr
from repro_torch.models.layers import dense_init
from repro_torch.serving.engine import LLMEngine

torch.set_num_threads(1)
MOE_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
FN_TOL = 1e-5
TOL = 2e-4            # whole-model logits and cache, as test_torch_model
NEAR_TIE = 1e-6
PROMPTS = ["how do i fix my bike", "hey how do i sell my laptop"]
MAX_LEN = 48


def _pin(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:                 # the thread ended meanwhile
            pass


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    """Per arch, in fp32: the JAX engine (its jitted prefill and decode
    serve the model tests at one token shape), the port's config and
    the JAX weights carried across. While the arch's tests run, every
    thread of this process is held to one core (as in
    ``test_torch_sharded.py``): the jitted prefill and decode are
    whole-program compiles, whose thread pools would otherwise spread
    over the cores that the other files of a parallel run are timed
    on."""
    name = request.param
    cores = os.sched_getaffinity(0)
    _pin({min(cores)})
    try:
        jcfg = dataclasses.replace(jax_smoke_config(name), dtype="float32")
        pcfg = dataclasses.replace(smoke_config(name), dtype="float32")
        jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jparams)
        jeng = JaxEngine(jcfg, params=jparams, max_len=MAX_LEN)
        yield jeng, tree, pcfg, ptr.params_from_numpy(pcfg, tree, "cpu")
    finally:
        _pin(cores)


@pytest.fixture(scope="module")
def layer0():
    """One MoE layer of the qwen2-moe smoke config (d 64, 4 experts of
    width 64, one shared expert) with fp32 weights drawn by numpy from a
    seed at the fan-in scale of ``init_params``, and its MoE config."""
    cfg = smoke_config("qwen2-moe-a2.7b").moe
    d, E, F = 64, cfg.n_experts, cfg.d_ff_expert
    shapes = {"router": (d, E), "wg": (E, d, F), "wu": (E, d, F),
              "wd": (E, F, d), "shared_wg": (d, F), "shared_wu": (d, F),
              "shared_wd": (F, d)}
    rng = np.random.default_rng(1)
    return {n: (rng.normal(size=s) * s[-2] ** -0.5).astype(np.float32)
            for n, s in shapes.items()}, cfg


def _both(w: dict):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def _kept_by_rule(ids: np.ndarray, n_groups: int, C: int) -> np.ndarray:
    """The reference's capacity rule on expert ids (T, k): in each of
    ``n_groups`` contiguous groups, a slot's position within its expert
    is the number of earlier slots, in (token, rank) order, with the same
    expert; slots at position C or later are dropped."""
    T, k = ids.shape
    keep = np.zeros(T * k, bool)
    flat = ids.reshape(n_groups, -1)
    for g in range(n_groups):
        seen: dict = {}
        for s, e in enumerate(flat[g]):
            keep[g * flat.shape[1] + s] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    return keep.reshape(T, k)


def _same_ids(got: np.ndarray, want: np.ndarray, probs: np.ndarray,
              k: int) -> int:
    """Expert ids identical, except on rows whose JAX k-th and (k+1)-th
    probabilities lie within NEAR_TIE (counted and returned)."""
    srt = -np.sort(-probs, axis=-1)
    near = srt[:, k - 1] - srt[:, k] <= NEAR_TIE if probs.shape[1] > k \
        else np.zeros(len(probs), bool)
    differ = (got != want).any(-1)
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    n = int((differ & near).sum())
    print(f"expert ids differing at a JAX near tie: {n}")
    return n


# --- configs ---------------------------------------------------------------

def test_moe_config_copies_match_jax():
    full = {"qwen2-moe-a2.7b": 14_315_587_584,
            "llama4-scout-17b-a16e": 107_769_861_120}
    for name in MOE_ARCHS:
        a, b = jax_get_arch(name), get_arch(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count() == full[name]
        assert a.active_param_count() == b.active_param_count()
        assert dataclasses.asdict(jax_smoke_config(name)) == \
            dataclasses.asdict(smoke_config(name)) == \
            dataclasses.asdict(smoke_config_for(name, "cpu"))
        assert smoke_config_for(name, "cuda").head_dim == 64


def test_capacity_and_sort_groups_match_jax(layer0):
    for T in (1, 2, 7, 8, 12, 16, 29, 64, 384, 512, 4096):
        for k in (1, 2, 4):
            for E in (4, 16, 60):
                for f in (1.0, 1.25, 2.0):
                    assert pm.capacity(T, k, E, f) == jm.capacity(T, k, E, f)
    # n_groups 32 halved until it divides T: T 40 -> 32, 16, 8; T 24 is
    # divisible by min(32, 24) = 24 itself; T 58 -> 2
    _, cfg = layer0
    assert cfg.n_groups == 32
    assert pm.sort_groups(40, cfg) == (8, pm.capacity(5, 2, 4, 1.25))
    assert pm.sort_groups(24, cfg)[0] == 24
    assert pm.sort_groups(58, cfg)[0] == 2


# --- router ------------------------------------------------------------------

def test_router_topk_and_load_balance_loss_match_jax(layer0):
    w, cfg = layer0
    x = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    for k in (1, 2, 3):
        ji, jw, jp = jm.router_topk(jnp.asarray(x), jnp.asarray(w["router"]),
                                    k)
        pi, pw, pp = pm.router_topk(torch.from_numpy(x),
                                    torch.from_numpy(w["router"]), k)
        assert pi.dtype == torch.int32 and pw.dtype == torch.float32
        assert _same_ids(pi.numpy(), np.asarray(ji), np.asarray(jp), k) == 0
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=FN_TOL,
                                   rtol=FN_TOL)
        np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=FN_TOL,
                                   rtol=FN_TOL)
        ja = jm.load_balance_loss(jp, ji, cfg.n_experts)
        pa = pm.load_balance_loss(pp, pi, cfg.n_experts)
        np.testing.assert_allclose(float(pa), float(ja), atol=FN_TOL,
                                   rtol=FN_TOL)


def test_router_topk_planted_ties_go_to_the_lowest_index():
    """Two identical router columns (and the three-way tie of
    [0.1, 0.3, 0.3, 0.3, 0.0]): dyadic inputs, so every logit is exact
    and the tied probabilities are equal in both packages."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, size=(16, 8)).astype(np.float32) / 4
    w = rng.integers(-4, 5, size=(8, 6)).astype(np.float32) / 8
    w[:, 4] = w[:, 1]            # experts 1 and 4 tie on every token
    w[:, 5] = w[:, 1]            # and 5
    probe = np.array([[0.1, 0.3, 0.3, 0.3, 0.0]], np.float32)
    for xs, ws, k in ((x, w, 2), (x, w, 4), (np.eye(1, dtype=np.float32),
                                             probe, 2)):
        ji, _, jp = jm.router_topk(jnp.asarray(xs), jnp.asarray(ws), k)
        pi, _, pp = pm.router_topk(torch.from_numpy(xs),
                                   torch.from_numpy(ws), k)
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        if ws is w:
            assert torch.equal(pp[:, 1], pp[:, 4])
    assert pi.tolist() == [[1, 2]]
    # the tie rule matters: torch.topk picks another index here
    assert torch.topk(torch.from_numpy(probe[0]), 2).indices.tolist() \
        != [1, 2]
    # each row of x has experts 1, 4, 5 tied: wherever one of them is
    # chosen and another is not, the chosen one is the lower index
    pi, _, pp = pm.router_topk(torch.from_numpy(x), torch.from_numpy(w), 2)
    for row in pi.tolist():
        tied = [e for e in row if e in (1, 4, 5)]
        assert tied == sorted(tied) and (not tied or tied[0] == 1)


# --- dispatch ----------------------------------------------------------------

def _drop_shared(w: dict, shared: bool) -> dict:
    return w if shared else {k: v for k, v in w.items()
                             if not k.startswith("shared_")}


# (shared expert, forced drops): the cases of each dispatch test
DISPATCH_CASES = [(s, d) for d in (False, True) for s in (True, False)]


def test_moe_ffn_sort_matches_jax(layer0):
    """With and without the shared expert: T 40 in 8 groups of 5
    (``n_groups`` 32 halved twice), C 8: no drop; and one group (C 32)
    with the router biased to expert 0 on inputs with a common offset:
    every token routes to it, and its slots past the capacity (the last
    8 in stable order) are dropped."""
    for shared, forced_drops in DISPATCH_CASES:
        _check_sort(layer0, shared, forced_drops)


def _check_sort(layer0, shared, forced_drops):
    w, cfg = layer0
    w = _drop_shared(dict(w), shared)
    x = np.random.default_rng(1).normal(size=(40, 64)).astype(np.float32)
    if forced_drops:
        cfg = dataclasses.replace(cfg, n_groups=1)
        x = x + 1.0
        w["router"] = w["router"].copy()
        w["router"][:, 0] += 0.25
    jw, tw = _both(w)
    jy, ja = jm.moe_ffn_sort(jnp.asarray(x), jw, cfg)
    py, pa, ids, kept = pm._moe_ffn_sort(torch.from_numpy(x), tw, cfg)
    y2, a2 = pm.moe_ffn_sort(torch.from_numpy(x), tw, cfg)
    assert torch.equal(py, y2) and torch.equal(pa, a2)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=FN_TOL,
                               rtol=FN_TOL)
    np.testing.assert_allclose(float(pa), float(ja), atol=FN_TOL,
                               rtol=FN_TOL)
    ji, _, jp = jm.router_topk(jnp.asarray(x), jw["router"], cfg.top_k)
    assert _same_ids(ids.numpy(), np.asarray(ji), np.asarray(jp),
                     cfg.top_k) == 0
    g, C = pm.sort_groups(len(x), cfg)
    assert (g, C) == ((1, 32) if forced_drops else (8, 8))
    want = _kept_by_rule(np.asarray(ji), g, C)
    assert np.array_equal(kept.numpy(), want)
    if forced_drops:
        assert bool((ids[:, 0] == 0).all())
        # expert 0 keeps the first C tokens; the later ones drop
        assert kept[:, 0].tolist() == [True] * C + [False] * (len(x) - C)
        assert int((~kept).sum()) == len(x) - C
    else:
        assert bool(kept.all())


def test_moe_ffn_sort_group_matches_jax(layer0):
    w, cfg = layer0
    x = np.random.default_rng(2).normal(size=(24, 64)).astype(np.float32)
    jw, tw = _both(w)
    jy, ja = jm._moe_ffn_sort_group(jnp.asarray(x), jw, cfg, 8)
    py, pa = pm._moe_ffn_sort_group(torch.from_numpy(x), tw, cfg, 8)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=FN_TOL,
                               rtol=FN_TOL)
    np.testing.assert_allclose(float(pa), float(ja), atol=FN_TOL,
                               rtol=FN_TOL)


def test_moe_ffn_einsum_matches_jax(layer0):
    """With and without the shared expert: T 8 (C 8, no drop) and T 40
    with every token routed to expert 0 (C 32: the last 8 slots of
    expert 0 drop)."""
    for shared, forced_drops in DISPATCH_CASES:
        _check_einsum(layer0, shared, forced_drops)


def _check_einsum(layer0, shared, forced_drops):
    w, cfg = layer0
    w = _drop_shared(dict(w), shared)
    rng = np.random.default_rng(4)
    if forced_drops:
        x = rng.normal(size=(40, 64)).astype(np.float32) + 1.0
        w["router"] = w["router"].copy()
        w["router"][:, 0] += 0.25
    else:
        x = rng.normal(size=(8, 64)).astype(np.float32)
    jw, tw = _both(w)
    jy, ja = jm.moe_ffn_einsum(jnp.asarray(x), jw, cfg)
    py, pa, ids, kept = pm._moe_ffn_einsum(torch.from_numpy(x), tw, cfg)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=FN_TOL,
                               rtol=FN_TOL)
    np.testing.assert_allclose(float(pa), float(ja), atol=FN_TOL,
                               rtol=FN_TOL)
    ji, _, jp = jm.router_topk(jnp.asarray(x), jw["router"], cfg.top_k)
    assert _same_ids(ids.numpy(), np.asarray(ji), np.asarray(jp),
                     cfg.top_k) == 0
    C = pm.capacity(len(x), cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert np.array_equal(kept.numpy(), _kept_by_rule(np.asarray(ji), 1, C))
    assert int((~kept).sum()) == (len(x) - C if forced_drops else 0)
    # moe_ffn picks the path by cfg.dispatch
    y2, _ = pm.moe_ffn(torch.from_numpy(x), tw,
                       dataclasses.replace(cfg, dispatch="einsum"))
    assert torch.equal(y2, py)


# --- init --------------------------------------------------------------------

def test_init_params_tree_matches_jax_eval_shape():
    for name in MOE_ARCHS:
        _check_init_tree(name)


def _check_init_tree(name):
    jcfg, pcfg = jax_smoke_config(name), smoke_config(name)
    want = jax.eval_shape(lambda: jtr.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    got = ptr.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got["layers"]) == sorted(want["layers"])
    flat = {**{f"layers/{k}": v for k, v in got["layers"].items()},
            **{k: v for k, v in got.items() if k != "layers"}}
    wflat = {**{f"layers/{k}": v for k, v in want["layers"].items()},
             **{k: v for k, v in want.items() if k != "layers"}}
    for k, v in flat.items():
        assert tuple(v.shape) == tuple(wflat[k].shape), k
        assert str(v.dtype).removeprefix("torch.") == str(wflat[k].dtype), k
    n = sum(v.numel() for v in flat.values())
    assert n == pcfg.param_count()


def test_dense_init_draws_a_stack_one_slab_at_a_time():
    """A stacked tensor is its slabs drawn one after another from the
    generator, each at the fan-in scale of ``shape[-2]`` and within
    +-3 sigma."""
    a = dense_init((3, 16, 8), torch.bfloat16,
                   torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    b = torch.stack([dense_init((16, 8), torch.bfloat16, g, "cpu")
                     for _ in range(3)])
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert float(a.float().abs().max()) <= 3.0 * 16 ** -0.5 * 1.01
    assert not torch.equal(a[0], a[1])


# --- model -------------------------------------------------------------------

def test_prefill_and_greedy_decode_match_jax(model):
    jeng, _, pcfg, pparams = model
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
    np.testing.assert_allclose(p_cache["v"].numpy(), np.asarray(j_cache["v"]),
                               atol=TOL, rtol=TOL)


def test_engine_generate_batch_matches_jax(model):
    jeng, _, pcfg, pparams = model
    want = jeng.generate_batch(PROMPTS, max_new_tokens=4)
    eng = LLMEngine(pcfg, params=pparams, max_len=MAX_LEN, device="cpu")
    assert eng.generate_batch(PROMPTS, max_new_tokens=4) == want
    assert eng.stats.batches == 1 and eng.stats.prefills == 2


def test_launcher_serves_qwen2_moe_on_cpu(capsys):
    from repro_torch.launch import serve
    s = serve.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                    "--requests", "20"])
    out = capsys.readouterr().out
    assert "errors                 0" in out and "device cpu" in out
    assert s["errors"] == 0

"""Port parity for the fault-tolerance slice: ``distributed/compression``,
``overlap.bucket_leaves``, ``fault_tolerance`` and
``checkpoint.restore(shardings=)`` against the JAX package on the CPU.

Compression is held bit for bit. The reference's arithmetic, checked
here against numpy on the same inputs, is a true fp32 division for both
``max|x| / 127`` and ``blocks / scale`` (JAX runs it op by op, so no
division by a constant is rewritten as a product), rounding half to
even, a 1e-12 floor, then the clip and the int8 cast; the port follows
it step for step. The clocks of ``HeartbeatMonitor`` and
``StragglerPolicy`` are the tests' own (each module's ``time`` is
patched): no sleeps."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import checkpoint as jck
from repro.distributed import compression as JC
from repro.distributed import fault_tolerance as JFT
from repro.distributed import overlap as JO
from repro.models import transformer as jtr
from repro_torch.configs import smoke_config
from repro_torch.distributed import checkpoint as pck
from repro_torch.distributed import compression as PC
from repro_torch.distributed import fault_tolerance as PFT
from repro_torch.distributed import overlap as PO
from repro_torch.models import transformer as ptr
from repro_torch.tree import flatten_with_path, leaves

torch.set_num_threads(1)
SIZES = (0, 1, 255, 256, 257, 4096)
FALSIFYING = (453605042, 1170)   # test_checkpoint_ft's failing draw


def _draw(seed: int, n: int) -> np.ndarray:
    """The JAX property test's input for (seed, n)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).astype(np.float32) * rng.uniform(0.01, 100)


def _inputs():
    for n in SIZES:
        yield f"n={n}", _draw(n, n)
    yield "falsifying", _draw(*FALSIFYING)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.itemsize])


def _same(got: torch.Tensor, want, what: str) -> None:
    assert tuple(got.shape) == np.asarray(want).shape, what
    assert np.array_equal(_bits(got.numpy()), _bits(want)), what


def test_quantize_dequantize_roundtrip_bit_identical():
    for name, x in _inputs():
        xb = x.astype(ml_dtypes.bfloat16)
        for dt, jx, px in (
                ("fp32", jnp.asarray(x), torch.from_numpy(x)),
                ("bf16", jnp.asarray(xb),
                 torch.from_numpy(xb.astype(np.float32)).bfloat16())):
            what = f"{name} {dt}"
            jq, js, jn = JC.quantize(jx)
            pq, ps, pn = PC.quantize(px)
            assert pn == jn == x.size and isinstance(pn, int), what
            _same(pq, jq, what + " q")
            _same(ps, js, what + " scale")
            _same(PC.dequantize(pq, ps, pn, px.shape),
                  JC.dequantize(jq, js, jn, jx.shape), what + " deq")
            _same(PC.roundtrip(px), JC.roundtrip(jx), what + " roundtrip")
            if x.size:   # the reference's arithmetic, spelled in numpy
                xf = np.asarray(jx, np.float32)
                blocks = np.pad(xf, (0, (-x.size) % 256)).reshape(-1, 256)
                scale = np.maximum(np.abs(blocks).max(1) / np.float32(127),
                                   np.float32(1e-12))
                q = np.clip(np.round(blocks / scale[:, None]), -127, 127)
                assert np.array_equal(scale, np.asarray(js)), what
                assert np.array_equal(q.astype(np.int8), np.asarray(jq)), \
                    what


def test_roundtrip_error_bound_of_the_port():
    """|x - roundtrip(x)| <= scale/2 + 2^-24 (|x| + |q| scale): the
    rounding of x / scale moves a value by at most half a step, and the
    division and the product q * scale each round once, by at most
    2^-24 of their magnitude (together about one fp32 spacing of |x|).
    The JAX property test allows scale/2 + 1e-6, which is below fp32
    rounding once |x| passes ~8: its falsifying draw (element 1014,
    x = -32.872032, one spacing 3.8e-6) exceeds it in both packages
    alike, and stays within this bound."""
    for seed, n in [FALSIFYING, (0, 2000), (1, 777), (2, 256), (3, 1)]:
        x = _draw(seed, n)
        px = torch.from_numpy(x)
        q, s, _ = PC.quantize(px)
        sx = s.repeat_interleave(PC.BLOCK)[:n].double()
        qx = q.reshape(-1)[:n].double().abs()
        err = (px.double() - PC.roundtrip(px).double()).abs()
        bound = sx / 2 + 2.0 ** -24 * (px.double().abs() + qx * sx)
        assert bool((err <= bound).all()), (seed, n)
        if (seed, n) == FALSIFYING:
            jax_bound = sx / 2 + 1e-6
            assert float(px[1014]) == pytest.approx(-32.872032)
            assert float(err[1014]) > float(jax_bound[1014])
            ref_err = np.abs(x - np.asarray(JC.roundtrip(jnp.asarray(x))))
            assert ref_err[1014] == np.float32(err[1014])


def _grad_tree(rng):
    return {"a": rng.standard_normal((4, 8)).astype(np.float32) * 3,
            "nested": {"b": (rng.standard_normal(300) * 0.01)
                       .astype(np.float32),
                       "c": [rng.standard_normal(3).astype(np.float32),
                             (rng.standard_normal((2, 2)) * 100)
                             .astype(np.float32)]}}


def test_compress_grads_with_feedback_fifty_steps_bit_identical():
    rng = np.random.default_rng(0)
    g0 = _grad_tree(rng)
    jres = JC.init_residual(jax.tree.map(jnp.asarray, g0))
    pres = PC.init_residual(_torch_tree(g0))
    for step in range(50):
        g = _grad_tree(rng)
        jq, jres = JC.compress_grads_with_feedback(
            jax.tree.map(jnp.asarray, g), jres)
        pq, pres = PC.compress_grads_with_feedback(_torch_tree(g), pres)
        jflat = jax.tree_util.tree_flatten_with_path(
            jq, is_leaf=lambda x: isinstance(x, tuple))[0]
        pflat = flatten_with_path(pq)
        # the port's tree flattens each (q, scale, n) tuple into 3 leaves
        assert len(pflat) == 3 * len(jflat)
        for k, (_, (q, s, n)) in enumerate(jflat):
            _same(pflat[3 * k][1], q, f"step {step} q")
            _same(pflat[3 * k + 1][1], s, f"step {step} scale")
            assert pflat[3 * k + 2][1] == n
        for a, b in zip(leaves(pres), jax.tree.leaves(jres)):
            _same(a, b, f"step {step} residual")


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.fixture(scope="module")
def qwen3_params():
    """The qwen3-1.7b smoke parameters (bf16) from JAX's init, and the
    same weights in the port's tree."""
    jcfg = jax_smoke_config("qwen3-1.7b")
    jparams = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    # bf16 -> fp32 -> bf16 is exact
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    return jparams, ptr.params_from_numpy(smoke_config("qwen3-1.7b"), tree,
                                          "cpu")


@pytest.mark.parametrize("bucket_bytes", [4 * 2**20, 96 * 2**10])
def test_bucket_leaves_matches_jax_on_qwen3_params(qwen3_params,
                                                   bucket_bytes):
    jparams, pparams = qwen3_params
    jvecs, junb = JO.bucket_leaves(jparams, bucket_bytes)
    pvecs, punb = PO.bucket_leaves(pparams, bucket_bytes)
    assert [v.shape[0] for v in pvecs] == [v.shape[0] for v in jvecs]
    assert len(pvecs) > (1 if bucket_bytes < 2**20 else 0)
    for a, b in zip(pvecs, jvecs):
        assert a.dtype == torch.float32
        _same(a, b, "bucket vector")
    back = punb(pvecs)
    jback = junb(jvecs)
    for (path, a), b, want in zip(flatten_with_path(back),
                                  jax.tree.leaves(jback), leaves(pparams)):
        assert a.dtype == want.dtype and torch.equal(a, want), path
        _same(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
              np.asarray(b).view(np.int16) if a.dtype == torch.bfloat16
              else b, "/".join(path))


def test_unbucket_roundtrips_every_dtype():
    """fp32, bf16 and int32 leaves in dicts, lists and tuples come back
    with their dtypes and bits, bucketed in the reference's leaf
    order."""
    g = torch.Generator().manual_seed(0)
    tree = {"z": torch.randn(5, 3, generator=g),
            "a": (torch.randn(7, generator=g).bfloat16(),
                  [torch.arange(-4, 9, dtype=torch.int32)]),
            "m": {"k": torch.randn(2, 2, 2, generator=g)}}
    jtree = {"z": jnp.asarray(tree["z"].numpy()),
             "a": (jnp.asarray(tree["a"][0].float().numpy())
                   .astype(jnp.bfloat16),
                   [jnp.asarray(tree["a"][1][0].numpy())]),
             "m": {"k": jnp.asarray(tree["m"]["k"].numpy())}}
    for bb in (1, 40, 2**20):
        vecs, unb = PO.bucket_leaves(tree, bb)
        jvecs, _ = JO.bucket_leaves(jtree, bb)
        assert len(vecs) == len(jvecs)
        for a, b in zip(vecs, jvecs):
            _same(a, b, f"bucket_bytes {bb}")
        back = unb(vecs)
        assert isinstance(back["a"], tuple)
        for a, b in zip(leaves(back), leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b), bb


def _restart_step(fail_at):
    """step(i, state) for either package: w <- 1.5 w + i, count + 1;
    raises at step i when ``fail_at(i, calls so far)`` says so."""
    calls = {"n": 0}

    def step(i, state):
        calls["n"] += 1
        if fail_at(i, calls["n"]):
            raise RuntimeError(f"injected failure at step {i}")
        return {"w": state["w"] * 1.5 + i,
                "n": [state["n"][0] + 1]}
    return step, calls


SCHEDULES = {
    # one failure at step 3, after the step-2 checkpoint
    "after_a_checkpoint": (dict(n_steps=6, ckpt_every=2),
                           lambda i, c: i == 3 and c == 4),
    # one failure at step 1, before the first checkpoint (step 4)
    "before_any_checkpoint": (dict(n_steps=6, ckpt_every=4),
                              lambda i, c: i == 1 and c == 2),
    # step 2 always fails: the third restart is one too many
    "max_restarts_exceeded": (dict(n_steps=6, ckpt_every=2,
                                   max_restarts=2),
                              lambda i, c: i == 2),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_run_with_restarts_matches_jax(tmp_path, schedule):
    kw, fail_at = SCHEDULES[schedule]
    w0 = np.arange(6, dtype=np.float32).reshape(2, 3) - 2
    out = {}
    for side, ft, state in (
            ("jax", JFT, {"w": jnp.asarray(w0),
                          "n": [jnp.zeros((), jnp.int32)]}),
            ("torch", PFT, {"w": torch.from_numpy(w0.copy()),
                            "n": [torch.zeros((), dtype=torch.int32)]})):
        step, calls = _restart_step(fail_at)
        ck = tmp_path / side
        try:
            final, rep = ft.run_with_restarts(step, state, ckpt_dir=str(ck),
                                              **kw)
            result = (jax.tree.map(np.asarray, final)
                      if side == "jax" else
                      {"w": final["w"].numpy(), "n": [final["n"][0].numpy()]},
                      dataclasses.asdict(rep))
        except RuntimeError as e:
            result = ("raised", str(e))
        latest = (jck if side == "jax" else pck).latest_step(ck)
        out[side] = (result, calls["n"], latest)
    (jres, jcalls, jlatest), (pres, pcalls, platest) = \
        out["jax"], out["torch"]
    assert (pcalls, platest) == (jcalls, jlatest)
    if schedule == "max_restarts_exceeded":
        assert pres == jres == ("raised", "injected failure at step 2")
        return
    (jfinal, jrep), (pfinal, prep) = jres, pres
    assert prep == jrep
    assert jrep["failures"] == jrep["restarts"] == 1
    assert jrep["restored_steps"] == ([2] if schedule ==
                                      "after_a_checkpoint" else [0])
    assert np.array_equal(pfinal["w"], jfinal["w"])
    assert int(pfinal["n"][0]) == int(jfinal["n"][0]) == kw["n_steps"]


def test_restore_places_leaves_on_the_shardings_devices(tmp_path):
    g = torch.Generator().manual_seed(1)
    tree = {"a": torch.randn(3, 4, generator=g),
            "b": [torch.randn(5, generator=g).bfloat16(),
                  torch.arange(4, dtype=torch.int32)]}
    pck.save(tmp_path, 3, tree)
    meta, cpu = torch.device("meta"), torch.device("cpu")
    got = pck.restore(tmp_path, 3, tree,
                      shardings={"a": meta, "b": [cpu, meta]})
    assert got["a"].device == meta and got["b"][1].device == meta
    assert got["b"][0].device == cpu
    assert got["b"][0].dtype == torch.bfloat16 and \
        torch.equal(got["b"][0], tree["b"][0])
    assert tuple(got["a"].shape) == (3, 4)
    like_meta = {"a": tree["a"].to(meta), "b": [tree["b"][0],
                                                tree["b"][1].to(meta)]}
    same = pck.restore(tmp_path, 3, like_meta)    # shardings=None
    assert same["a"].device == meta and same["b"][0].device == cpu
    with pytest.raises(ValueError, match="leaves"):
        pck.restore(tmp_path, 3, tree, shardings={"a": cpu, "b": [cpu]})
    moved = PFT.elastic_remesh(tree, {"a": meta, "b": [meta, cpu]})
    assert [t.device for t in leaves(moved)] == [meta, meta, cpu]
    # a checkpoint the JAX package wrote restores onto the devices asked
    jck.save(tmp_path / "jax", 1, jax.tree.map(
        lambda t: np.asarray(t.float()) if t.dtype == torch.bfloat16
        else t.numpy(), tree))
    got = pck.restore(tmp_path / "jax", 1,
                      {"a": tree["a"], "b": [tree["b"][0].float(),
                                             tree["b"][1]]},
                      shardings={"a": cpu, "b": [cpu, cpu]})
    assert torch.equal(got["a"], tree["a"])


def test_leaf_hash_matches_jax_on_every_layout():
    """The port hashes a leaf's bytes in place; the reference hashes
    ``arr.tobytes()``. The digests agree on 0-d, empty, transposed,
    strided, bf16 and bool leaves."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 8)).astype(np.float32)
    bf = torch.from_numpy(x).bfloat16()
    for arr in (np.float32(2.5) * np.ones((), np.float32),
                np.zeros((0, 4), np.float32), x.T, x[:, ::3],
                np.arange(12, dtype=np.int64)[::5],
                pck._host(bf), pck._host(bf[:, ::2].contiguous()),
                np.asarray(bf.float().numpy().astype(ml_dtypes.bfloat16)),
                np.array([True, False, True])):
        assert pck._hash(arr) == jck._hash(arr), (arr.dtype, arr.shape)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def _fake_time(monkeypatch, clock):
    for mod in (JFT, PFT):
        monkeypatch.setattr(mod, "time",
                            types.SimpleNamespace(monotonic=clock.monotonic))


def test_heartbeat_monitor_matches_jax_under_a_test_clock(monkeypatch):
    clock = _Clock()
    _fake_time(monkeypatch, clock)
    logs = {}
    for side, ft in (("jax", JFT), ("torch", PFT)):
        clock.now = 100.0
        dead = []
        mon = ft.HeartbeatMonitor(deadline_s=5.0, on_dead=dead.append)
        trace = []
        mon.beat("w0")
        mon.beat("w1")
        for t, beats in ((104.0, ["w1"]), (105.0, []), (106.5, ["w2"]),
                         (110.0, ["w0"]), (111.6, []), (120.0, [])):
            clock.now = t
            for w in beats:
                mon.beat(w)
            trace.append((t, mon.check(), sorted(mon.dead)))
        logs[side] = (trace, dead)
    assert logs["torch"] == logs["jax"]
    trace, dead = logs["torch"]
    assert trace[1][1] == [] and trace[2][1] == ["w0"]   # 6.5 s > 5 s
    assert dead[0] == "w0" and "w0" not in trace[3][2]   # a beat revives


def test_straggler_policy_matches_jax_under_a_test_clock(monkeypatch):
    clock = _Clock()
    _fake_time(monkeypatch, clock)
    logs = {}
    for side, ft in (("jax", JFT), ("torch", PFT)):
        clock.now = 0.0
        sp = ft.StragglerPolicy(deadline_s=2.0)
        trace = []
        sp.started("t1")
        sp.started("t2")
        for t, fin in ((1.0, "t2"), (2.5, None), (3.0, None), (5.0, None)):
            clock.now = t
            if fin:
                sp.finished(fin)
            trace.append((t, sp.stragglers(), sp.redispatched))
        logs[side] = trace
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][1] == (2.5, ["t1"], 1)
    assert logs["torch"][3] == (5.0, ["t1"], 2)

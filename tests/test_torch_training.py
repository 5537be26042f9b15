"""Port parity: recsys training against the JAX package on the CPU.

Every ``train_loss`` and its gradients (``value_and_grad``), AdamW's
``update``, ``lr_schedule``, ``make_step``, ``accumulate_microbatches``,
the train loop with its checkpoint and resume, and checkpoints with list
leaves written by one package and restored in the other. Weights and
batches are made with numpy from seeds and handed to both packages; the
JAX references run eagerly (no ``jax.jit``).

Tolerances: a loss within rtol 1e-5; a gradient leaf within 1e-4 *
max|g_ref| + 1e-7 (op order differs, and the port's mean bag weighs by
1/count where JAX divides); after an optimizer step, params and the
fp32 master within 1e-2 * lr absolute (Adam's first step is
g / (|g| + eps), which turns a rounding difference in a tiny gradient
into a visible one); ``grad_norm`` within rtol 1e-6; a checkpoint's
leaves restored bit for bit.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.distributed import checkpoint as JC
from repro.distributed.overlap import \
    accumulate_microbatches as jax_accumulate
from repro.models import recsys as JR
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch.configs import smoke_config
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.distributed import checkpoint as PC
from repro_torch.distributed.overlap import accumulate_microbatches
from repro_torch.models import recsys as PR
from repro_torch.training import optimizer as PO
from repro_torch.training import train_loop as PT
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)
ARCHS = ("sasrec", "mind", "bst", "wide-deep")
LR = PO.AdamWConfig().lr


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _jax_named(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v, np.float32)
            if v.dtype == jnp.bfloat16 else np.asarray(v)
            for path, v in flat}


def _port_named(tree) -> dict:
    return {"/".join(path): _np(v) for path, v in flatten_with_path(tree)}


def _model(arch, B=8, seed=0):
    """Smoke config, weights as numpy (the port's seeded init; for
    Wide&Deep a random wide table in place of the zero init) and one
    train batch of B rows with some padded history."""
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    tree = jax.tree.map(lambda t: t.numpy(), PR.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    rng = np.random.default_rng(seed + 1)
    if arch == "wide-deep":
        tree["wide"] = (0.1 * rng.standard_normal(tree["wide"].shape)) \
            .astype(np.float32)
    stream = recsys_batches(cfg, B, seed=seed + 2)
    batches = [next(stream) for _ in range(2)]
    for b in batches:
        if "seq" in b:
            b["seq"][0, :3] = 0
        if arch == "sasrec":
            b["pos"][0, :2] = 0
    return jcfg, cfg, tree, batches


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(cfg, tree):
    return PR.params_from_numpy(cfg, tree, "cpu")


def _close_trees(got, want, atol, what):
    got, want = _port_named(got), _jax_named(want)
    assert got.keys() == want.keys(), what
    for name in want:
        assert got[name].shape == want[name].shape, (what, name)
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


def _close_grads(got, want):
    got, want = _port_named(got), _jax_named(want)
    assert got.keys() == want.keys()
    for name, g in want.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        err = float(np.abs(got[name] - g).max())
        assert err <= tol, (name, err, tol)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    jcfg, cfg, tree, (batch, _) = _model(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JR.train_loss(jcfg, p, jb))(_jax(tree))
    loss, grads = PO.value_and_grad(
        lambda p, b: PR.train_loss(cfg, p, b))(
            _port(cfg, tree), PR.batch_from_numpy(batch, "cpu"))
    assert loss.dim() == 0 and not loss.requires_grad
    assert _rel(loss, jloss) <= 1e-5
    _close_grads(grads, jgrads)


def _opt_tree():
    """Wide&Deep smoke's weights (lists under ``mlp``): the update's JAX
    ops then compile once for the shapes ``make_step`` uses too."""
    return _model("wide-deep")[2]


def test_update_matches_jax_over_three_steps():
    """Three AdamW updates with clipping active and bf16 moments (fp32
    moments, the default, step against JAX in the ``make_step`` and
    checkpoint tests, which share these leaves' eager JAX compiles)."""
    moments = "bfloat16"
    rng = np.random.default_rng(12)
    tree = _opt_tree()
    jcfg = JO.AdamWConfig(moments_dtype=moments)
    cfg = PO.AdamWConfig(moments_dtype=moments)
    jp, pp = _jax(tree), jax.tree.map(torch.from_numpy, tree)
    js, ps = JO.init(jp, jcfg), PO.init(pp, cfg)
    assert ps.keys() == js.keys() == {"mu", "nu", "master", "step"}
    assert ps["step"].dtype == torch.int32 and ps["step"].dim() == 0
    # moments: a rounding of a bf16 word apart, measured against the
    # leaf's largest moment (mu * b1 + (1 - b1) * g cancels)
    mrtol = 2.0 ** -7
    for step in range(3):
        g = jax.tree.map(lambda x: 3 * rng.standard_normal(x.shape)
                         .astype(np.float32), tree)
        jp, js, jn = JO.update(_jax(g), js, jp, jcfg)
        pp, ps, pn = PO.update(jax.tree.map(torch.from_numpy, g), ps, pp,
                               cfg)
        assert float(jn) > cfg.grad_clip          # clipping is active
        assert _rel(pn, jn) <= 1e-6
        assert int(ps["step"]) == int(js["step"]) == step + 1
        assert all(v.dtype == getattr(torch, moments)
                   for k in ("mu", "nu") for v in
                   (leaf for _, leaf in flatten_with_path(ps[k])))
        _close_trees(pp, jp, 1e-2 * LR, f"params {step}")
        _close_trees(ps["master"], js["master"], 1e-2 * LR, f"master {step}")
        for k in ("mu", "nu"):
            got, want = _port_named(ps[k]), _jax_named(js[k])
            for name in want:
                np.testing.assert_allclose(
                    got[name], want[name], rtol=mrtol,
                    atol=mrtol * float(np.abs(want[name]).max()),
                    err_msg=f"{k} {name}")


def test_lr_schedule_matches_jax():
    kw = dict(n_steps=20, warmup_steps=5, lr=3e-4, lr_min_ratio=0.1)
    tcfg, jtcfg = PT.TrainConfig(**kw), JT.TrainConfig(**kw)
    for s in (0, 3, 5, 12, 20):
        got = PT.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        want = JT.lr_schedule(jtcfg, jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)
    assert float(PT.lr_schedule(tcfg, torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(PT.lr_schedule(tcfg, torch.tensor(5))),
                               3e-4, rtol=1e-6)
    np.testing.assert_allclose(
        float(PT.lr_schedule(tcfg, torch.tensor(20))), 3e-5, rtol=1e-6)


def test_make_step_matches_jax_over_two_steps():
    """Two ``make_step`` steps on Wide&Deep smoke from the same weights
    and batches (warmup 1, so the first step's lr is 0 and the second's
    the full rate: the lr = 1 update and the interpolation both count)."""
    jcfg, cfg, tree, batches = _model("wide-deep")
    kw = dict(n_steps=4, warmup_steps=1)
    jstep = JT.make_step(lambda p, b: JR.train_loss(jcfg, p, b),
                         JT.TrainConfig(**kw), JO.AdamWConfig())
    pstep = PT.make_step(lambda p, b: PR.train_loss(cfg, p, b),
                         PT.TrainConfig(**kw), PO.AdamWConfig())
    jp, pp = _jax(tree), _port(cfg, tree)
    js, ps = JO.init(jp, JO.AdamWConfig()), PO.init(pp, PO.AdamWConfig())
    for batch in batches:
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pp, ps, pm = pstep(pp, ps, PR.batch_from_numpy(batch, "cpu"))
        assert _rel(pm["loss"], jm["loss"]) <= 1e-5
        assert _rel(pm["grad_norm"], jm["grad_norm"]) <= 1e-6
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        _close_trees(pp, jp, 1e-2 * LR, "params")
        _close_trees(ps["master"], js["master"], 1e-2 * LR, "master")
    assert float(pm["lr"]) > 0 and int(ps["step"]) == 2


def test_accumulate_microbatches_matches_jax():
    jcfg, cfg, tree, (batch, _) = _model("sasrec")
    jloss, jgrads = jax_accumulate(
        lambda p, b: JR.train_loss(jcfg, p, b), 2)(
            _jax(tree), {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = accumulate_microbatches(
        lambda p, b: PR.train_loss(cfg, p, b), 2)(
            _port(cfg, tree), PR.batch_from_numpy(batch, "cpu"))
    assert _rel(loss, jloss) <= 1e-5
    assert all(g.dtype == torch.float32
               for _, g in flatten_with_path(grads))
    _close_grads(grads, jgrads)
    with pytest.raises(ValueError, match="microbatches"):
        accumulate_microbatches(lambda p, b: PR.train_loss(cfg, p, b), 3)(
            _port(cfg, tree), PR.batch_from_numpy(batch, "cpu"))


def test_train_loss_falls_and_resumes_from_its_checkpoint(tmp_path):
    """Wide&Deep smoke on one repeated batch: the loss falls over 8
    steps; a run whose data fails after step 5 (checkpointed at step 4)
    and is resumed by a new ``train`` call gives the uninterrupted run's
    steps 5-8."""
    _, cfg, tree, (batch, _) = _model("wide-deep", B=32)
    b = PR.batch_from_numpy(batch, "cpu")

    def loss_fn(p, bb):
        return PR.train_loss(cfg, p, bb)

    def preempted(n):
        yield from itertools.repeat(b, n)
        raise RuntimeError("preempted")
    tcfg = PT.TrainConfig(n_steps=8, ckpt_every=4, log_every=1,
                          warmup_steps=1, lr=1e-2)
    _, _, full = PT.train(loss_fn, _port(cfg, tree), itertools.repeat(b),
                          tcfg)
    losses = [h["loss"] for h in full]
    assert [h["step"] for h in full] == list(range(1, 9))
    # the first step's lr is 0 (warmup): its update changes nothing
    assert losses[-1] < losses[1] == losses[0]
    ckpt = dataclasses.replace(tcfg, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="preempted"):
        PT.train(loss_fn, _port(cfg, tree), preempted(5), ckpt, jit=False)
    assert PC.latest_step(tmp_path) == 4
    params, opt_state, hist = PT.train(
        loss_fn, _port(cfg, tree), itertools.repeat(b), ckpt)
    assert [h["step"] for h in hist] == [5, 6, 7, 8]
    np.testing.assert_allclose([h["loss"] for h in hist], losses[4:],
                               rtol=1e-6)
    assert int(opt_state["step"]) == 8 and PC.latest_step(tmp_path) == 8
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["step_00000004", "step_00000008"]


def _wd_steps():
    jcfg, cfg, tree, batches = _model("wide-deep")
    jstep = JO.make_train_step(lambda p, b: JR.train_loss(jcfg, p, b),
                               JO.AdamWConfig())
    pstep = PO.make_train_step(lambda p, b: PR.train_loss(cfg, p, b),
                               PO.AdamWConfig())
    return cfg, tree, batches, jstep, pstep


def test_jax_checkpoint_restores_into_the_port_and_steps_alike(tmp_path):
    cfg, tree, (b1, b2), jstep, pstep = _wd_steps()
    jp = _jax(tree)
    jp, js, _ = jstep(jp, JO.init(jp, JO.AdamWConfig()),
                      {k: jnp.asarray(v) for k, v in b1.items()})
    JC.save(tmp_path, 1, {"params": jp, "opt": js})
    fresh = PR.init_params(cfg, torch.Generator().manual_seed(9), "cpu")
    like = {"params": fresh, "opt": PO.init(fresh, PO.AdamWConfig())}
    got = PC.restore(tmp_path, 1, like)
    want = _jax_named({"params": jp, "opt": js})
    named = _port_named(got)
    assert named.keys() == want.keys()
    for name, w in want.items():
        assert named[name].dtype == w.dtype
        np.testing.assert_array_equal(named[name], w, err_msg=name)
    assert got["opt"]["step"].dtype == torch.int32
    jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b2.items()})
    pp, ps, pm = pstep(got["params"], got["opt"],
                       PR.batch_from_numpy(b2, "cpu"))
    assert _rel(pm["loss"], jm["loss"]) <= 1e-5
    assert _rel(pm["grad_norm"], jm["grad_norm"]) <= 1e-6
    _close_trees(pp, jp, 1e-2 * LR, "params")
    _close_trees(ps, js, 1e-2 * LR, "opt")


def test_port_checkpoint_restores_into_jax(tmp_path):
    cfg, tree, (b1, _), _, pstep = _wd_steps()
    pp = _port(cfg, tree)
    pp, ps, _ = pstep(pp, PO.init(pp, PO.AdamWConfig()),
                      PR.batch_from_numpy(b1, "cpu"))
    PC.save(tmp_path, 1, {"params": pp, "opt": ps})
    jp = _jax(tree)
    got = JC.restore(tmp_path, 1,
                     {"params": jp, "opt": JO.init(jp, JO.AdamWConfig())})
    want = _port_named({"params": pp, "opt": ps})
    named = _jax_named(got)
    assert named.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_array_equal(named[name], w, err_msg=name)


def _list_tree(rng):
    return {"mlp": [{"w": rng.standard_normal((3, 2)).astype(np.float32),
                     "b": np.zeros(2, np.float32)},
                    {"w": rng.standard_normal((2, 1)).astype(np.float32),
                     "b": np.ones(1, np.float32)}],
            "blocks": [{"ln1": np.ones(4, np.float32)}],
            "step": np.int32(7)}


def test_checkpoint_list_leaf_names_match_jax_manifest(tmp_path):
    """A tree with lists is saved leaf by leaf under the names JAX gives
    (``mlp/0/b``, ...), with the same files, shapes, dtypes and hashes."""
    tree = _list_tree(np.random.default_rng(3))
    JC.save(tmp_path / "jax", 5, _jax(tree))
    PC.save(tmp_path / "port", 5,
            jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree))
    manifests = [json.loads((tmp_path / w / "step_00000005" /
                             "manifest.json").read_text())["leaves"]
                 for w in ("jax", "port")]
    assert manifests[1] == manifests[0]
    assert sorted(manifests[1]) == ["blocks/0/ln1", "mlp/0/b", "mlp/0/w",
                                    "mlp/1/b", "mlp/1/w", "step"]
    assert all(m["dtype"] != "object" for m in manifests[1].values())


def test_restore_refuses_a_corrupt_leaf(tmp_path):
    tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                        _list_tree(np.random.default_rng(4)))
    PC.save(tmp_path, 1, tree)
    back = PC.restore(tmp_path, 1, jax.tree.map(torch.zeros_like, tree))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(flatten_with_path(back), flatten_with_path(tree)))
    f = tmp_path / "step_00000001" / "mlp__1__w.npy"
    np.save(f, np.load(f) + 1)
    with pytest.raises(IOError, match="mlp/1/w"):
        PC.restore(tmp_path, 1, tree)


def test_checkpoint_round_trips_bf16_moments_as_jax_writes_them(tmp_path):
    tree = _opt_tree()
    cfg = PO.AdamWConfig(moments_dtype="bfloat16")
    pp = jax.tree.map(torch.from_numpy, tree)
    _, ps, _ = PO.update(jax.tree.map(torch.from_numpy, tree),
                         PO.init(pp, cfg), pp, cfg)
    PC.save(tmp_path / "port", 1, ps)
    back = PC.restore(tmp_path / "port", 1,
                      PO.init(pp, cfg))
    assert all(a.dtype == b.dtype and torch.equal(a, b) for (_, a), (_, b)
               in zip(flatten_with_path(back), flatten_with_path(ps)))
    JC.save(tmp_path / "jax", 1,
            jax.tree.map(lambda t: jnp.asarray(_np(t)).astype(
                jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy()
                .dtype), ps))
    man = [json.loads((tmp_path / w / "step_00000001" / "manifest.json")
                      .read_text())["leaves"] for w in ("jax", "port")]
    assert {k: v["hash"] for k, v in man[0].items()} \
        == {k: v["hash"] for k, v in man[1].items()}

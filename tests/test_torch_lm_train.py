"""Port parity: LM training (``models/transformer.forward`` and
``train_loss``, ``data/lm_data.py``, ``build_lm`` and
``launch/train.py``) against the JAX package on the CPU.

The models are fp32 copies of the smoke configs (``dtype="float32"``):
the dense ``qwen3-1.7b`` and both MoE configs, whose load-balance aux
enters the loss. Weights are JAX's ``init_params`` carried across by
``params_from_numpy``; tokens are drawn by numpy from a seed. The JAX
functions run eagerly (no ``jax.jit``), with every thread of this
process held to one core while this file runs (as
``test_torch_moe.py`` does).

Tolerances: hidden states within 1e-5 of max |h|; a loss within rtol
1e-5; a gradient leaf within 1e-4 * max|g_ref| + 1e-7; after an AdamW
step, params and the fp32 master within 1e-2 * lr absolute and
grad_norm within rtol 1e-5. The port's remat (``torch.utils.checkpoint``)
must not change a loss or a gradient bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.data import lm_data as JLD
from repro.launch.mesh import make_smoke_mesh
from repro.launch.workloads import build_lm as jax_build_lm
from repro.models import transformer as JT
from repro.training import optimizer as JO
from repro_torch import configs as PCFG
from repro_torch.data import lm_data as PLD
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.workloads import ADAMW, build_lm
from repro_torch.models import attention as plain
from repro_torch.models import transformer as PT
from repro_torch.training import optimizer as PO
from repro_torch.tree import flatten_with_path

torch.set_num_threads(1)
ARCHS = ("qwen3-1.7b", "qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
LR = PO.AdamWConfig().lr
B, S, CHUNK = 2, 64, 16       # vocab_chunk_seq < S: 4 loss chunks


def _pin(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:                 # the thread ended meanwhile
            pass


@pytest.fixture(scope="module", autouse=True)
def one_core():
    cores = os.sched_getaffinity(0)
    _pin({min(cores)})
    yield
    _pin(cores)


def _model(arch):
    """fp32 copies of the smoke config in both packages, JAX's weights
    as numpy, and a batch of B x S with a few masked labels."""
    jcfg = dataclasses.replace(JCFG.smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(PCFG.smoke_config(arch), dtype="float32")
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[0, :5] = -1
    return jcfg, cfg, tree, {"tokens": toks, "labels": labels}


def _jax_named(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path):
            v if isinstance(v, jax.ShapeDtypeStruct) else np.asarray(v)
            for path, v in flat}


def _port_named(tree) -> dict:
    return {"/".join(p): v.detach().float().numpy()
            for p, v in flatten_with_path(tree)}


def _sig(named: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in named.items()}


def _tree_sig(tree) -> dict:
    return _sig({"/".join(p): v for p, v in flatten_with_path(tree)})


def _close_grads(got, want):
    got, want = _port_named(got), _jax_named(want)
    assert got.keys() == want.keys()
    for name, g in want.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        err = float(np.abs(got[name] - g).max())
        assert err <= tol, (name, err, tol)


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_lm_data_matches_reference_bit_for_bit():
    for args in ((512, 3, 40, 0), (1000, 2, 17, 5)):
        a, b = JLD.synthetic_lm_batches(*args), PLD.synthetic_lm_batches(*args)
        for _ in range(2):
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_loss_match_jax(arch):
    """``forward`` (hidden, aux) and ``train_loss`` over 4 vocab chunks
    with masked labels, with every gradient leaf, against eager
    ``jax.value_and_grad``; the MoE aux is nonzero and enters the loss."""
    jcfg, cfg, tree, b = _model(arch)
    params = PT.params_from_numpy(cfg, tree, "cpu")
    jh, jaux = JT.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                          jnp.asarray(b["tokens"]))
    with torch.no_grad():
        h, aux = PT.forward(cfg, params, torch.from_numpy(b["tokens"]))
    jh = np.asarray(jh)
    np.testing.assert_allclose(h.numpy(), jh, rtol=0,
                               atol=1e-5 * np.abs(jh).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=0)
    assert (float(jaux) > 0) == cfg.is_moe
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jl, jg = jax.value_and_grad(lambda p: JT.train_loss(
        jcfg, p, jb, vocab_chunk_seq=CHUNK))(jax.tree.map(jnp.asarray, tree))
    pl, pg = PO.value_and_grad(lambda p, x: PT.train_loss(
        cfg, p, x, vocab_chunk_seq=CHUNK))(params, _port_batch(b))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _close_grads(pg, jg)


def test_train_step_matches_jax():
    """One ``make_train_step`` step of the dense model (the default
    ``vocab_chunk_seq``, one chunk at S 64): loss, grad_norm, params and
    the fp32 master against JAX's step."""
    jcfg, cfg, tree, b = _model("qwen3-1.7b")
    jstep = JO.make_train_step(lambda p, x: JT.train_loss(jcfg, p, x),
                               JO.AdamWConfig())
    jp = jax.tree.map(jnp.asarray, tree)
    jp1, js1, jm = jstep(jp, JO.init(jp, JO.AdamWConfig()),
                         {k: jnp.asarray(v) for k, v in b.items()})
    step = PO.make_train_step(lambda p, x: PT.train_loss(cfg, p, x), ADAMW)
    pp = PT.params_from_numpy(cfg, tree, "cpu")
    pp1, ps1, pm = step(pp, PO.init(pp, ADAMW), _port_batch(b))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    for got, want in ((pp1, jp1), (ps1["master"], js1["master"])):
        got, want = _port_named(got), _jax_named(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=1e-2 * LR, err_msg=k)


def test_remat_and_the_flash_function_keep_loss_and_gradients():
    """Remat on and off give bit-identical losses and gradients (MoE
    config, aux included). Then the ``FlashAttention`` Function with the
    plain attention standing in for the kernel (which runs on the card
    only): its forward runs twice a layer a step under remat (forward
    and recompute), and its backward (the plain version recomputed and
    differentiated) gives the plain path's loss and gradients."""
    _, cfg, tree, b = _model("qwen2-moe-a2.7b")
    params = PT.params_from_numpy(cfg, tree, "cpu")

    def grads(c):
        return PO.value_and_grad(lambda p, x: PT.train_loss(c, p, x))(
            params, _port_batch(b))
    l_on, g_on = grads(cfg)
    l_off, g_off = grads(dataclasses.replace(cfg, remat=False))
    assert torch.equal(l_on, l_off)
    for (k, x), (_, y) in zip(flatten_with_path(g_on),
                              flatten_with_path(g_off)):
        assert torch.equal(x, y), k

    calls = []

    def stand_in(q, k, v):
        calls.append(q.shape)
        return plain.causal_attention(q, k, v)
    saved = flash_kernel.flash_attention, PT.attention
    flash_kernel.flash_attention = stand_in
    PT.attention = flash_ops.FlashAttention.apply
    try:
        l_fn, g_fn = grads(cfg)
    finally:
        flash_kernel.flash_attention, PT.attention = saved
    assert len(calls) == 2 * cfg.n_layers
    torch.testing.assert_close(l_fn, l_on, rtol=1e-6, atol=0)
    for (k, x), (_, y) in zip(flatten_with_path(g_fn),
                              flatten_with_path(g_on)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("name", ["train_4k", "prefill_32k", "decode_32k"])
def test_build_lm_every_shape_matches_jax_abstract_args(name):
    """``build_lm`` at the dense smoke config with the batch cut to 2 and
    the sequence to 128 (S 32,768 takes ~17 GB of plain attention scores
    on the CPU): parameters, batch / cache / token keys, shapes and
    dtypes and ``model_flops`` equal to the JAX builder's abstract args
    on a one-device mesh at the same cut shape; one call runs."""
    jcfg, cfg = JCFG.smoke_config("qwen3-1.7b"), \
        PCFG.smoke_config("qwen3-1.7b")
    jshape = dataclasses.replace(JCFG.get_shape(jcfg, name), seq_len=128,
                                 global_batch=2)
    shape = dataclasses.replace(PCFG.get_shape(cfg, name), seq_len=128)
    jwl = jax_build_lm(jcfg, jshape, make_smoke_mesh(1))
    wl = build_lm(cfg, shape, device="cpu", seed=1, batch=2)
    assert wl.model_flops == jwl.model_flops
    for got, want in zip(wl.args, jwl.args):
        if not isinstance(want, dict):                     # decode's token
            got, want = {"x": got}, {"x": want}
        assert _tree_sig(got) == _sig(_jax_named(want))
    out = wl.fn(*wl.args)
    V = cfg.vocab_size
    if name == "train_4k":
        _, state, m = out
        assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))
        assert abs(float(m["loss"]) - np.log(V)) < 1.0
        assert _sig(next(wl.batches)) == _sig(wl.args[2])
    elif name == "prefill_32k":
        logits, cache = out
        assert logits.shape == (2, V) and bool(logits.isfinite().all())
        assert cache["k"].shape == (cfg.n_layers, 2, 128, cfg.n_kv_heads,
                                    cfg.head_dim)
    else:
        logits, cache = out
        assert logits.shape == (2, V) and bool(logits.isfinite().all())
        assert cache["length"].tolist() == [128, 128]
        assert wl.args[1]["length"].tolist() == [127, 127]


def test_launch_train_smoke_on_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --smoke --steps
    6`` in-process: the reference's step lines at steps 1 and 5, the
    loss falling, no checkpoint before step 20, then ``done``."""
    rows = launch_train.main(["--device", "cpu", "--smoke", "--steps", "6",
                              "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device cpu | arch qwen3-1.7b-smoke"
    assert [r[0] for r in rows] == [1, 5] and rows[1][1] < rows[0][1]
    assert [ln.split()[:2] for ln in out[1:3]] == [["step", "1"],
                                                   ["step", "5"]]
    assert out[-1] == "done"
    assert not (tmp_path / "ck").exists()

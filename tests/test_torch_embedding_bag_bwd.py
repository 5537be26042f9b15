"""The bag's backward on the CPU: the plain version
(``kernels/embedding_bag/ref.embedding_bag_backward``, ``index_add_``)
adds each row's terms in ascending flat position, the order the CUDA
backward kernel adds in (so the two agree bit for bit on the card), and
it equals ``jax.grad`` of the JAX package's ragged bag
(``repro/models/recsys.py:39-56``, ``jax.ops.segment_sum``) on ids with
many repeats. Eager JAX only, no compile of a whole program."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as JR
from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward

torch.set_num_threads(1)


def test_plain_backward_adds_in_position_order():
    """The same sum written as the kernel's loop (row by row, terms in
    ascending b * m + j, one rounding a multiply and an add) gives the
    plain version's bits, repeated ids and zero weights included."""
    g = torch.Generator().manual_seed(9)
    B, m, d, V = 50, 5, 7, 13
    ids = torch.randint(0, V, (B, m), generator=g, dtype=torch.int32)
    w = torch.rand((B, m), generator=g) * 3
    w[3] = 0.0
    grad = torch.randn((B, d), generator=g) * 100
    keys, pos = torch.sort(ids.reshape(-1), stable=True)
    want = torch.zeros((V, d))
    for q in range(B * m):
        b, j = divmod(int(pos[q]), m)
        r = int(keys[q])
        want[r] = want[r] + w[b, j] * grad[b]
    got = embedding_bag_backward(grad, ids, w, V)
    assert torch.equal(got, want)
    assert not got[torch.isin(torch.arange(V), ids.reshape(-1)).logical_not()
                   ].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_backward_matches_jax_grad_of_the_ragged_bag(mode):
    """Fixed bags of m ids (most ids repeated many times) as the ragged
    bag's segments: the table's gradient of sum(bag * G) by the plain
    backward (weights 1, or 1/m for the mean) against ``jax.grad`` of
    ``embedding_bag_ragged`` within 1e-6."""
    rng = np.random.default_rng(5)
    V, d, B, m = 24, 6, 40, 5
    table = rng.standard_normal((V, d)).astype(np.float32)
    ids = rng.integers(0, V // 3, (B, m)).astype(np.int32)
    G = rng.standard_normal((B, d)).astype(np.float32)
    seg = np.repeat(np.arange(B, dtype=np.int32), m)
    want = np.asarray(jax.grad(lambda t: jnp.sum(JR.embedding_bag_ragged(
        t, jnp.asarray(ids.reshape(-1)), jnp.asarray(seg), B, mode=mode)
        * G))(jnp.asarray(table)))
    w = torch.full((B, m), 1.0 if mode == "sum" else 1.0 / m)
    got = embedding_bag_backward(torch.from_numpy(G), torch.from_numpy(ids),
                                 w, V)
    assert got.shape == (V, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not want[V // 3:].any() and not got[V // 3:].any()

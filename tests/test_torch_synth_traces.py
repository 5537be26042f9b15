"""The port's copy of the trace generator (``repro_torch.data.synth_traces``)
against ``repro.data.synth_traces``: the same presets, bit-identical traces
and benchmarks, and the same tuned threshold t* from the port's simulator
as from the JAX one. One thread; one JAX simulator compile per preset."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import synth_traces as J
from repro_torch.data import synth_traces as P

torch.set_num_threads(1)

# presets cut in size (the generating process is unchanged); the second
# seed also turns the freshness axis on, which draws after the trace
CUTS = {"lmarena_like": dict(n_requests=3000, n_classes=600),
        "search_like": dict(n_requests=4000, n_classes=1500)}
CASES = [(name, seed) for name in CUTS for seed in (None, 101)]


def _specs(name, seed):
    kw = dict(CUTS[name])
    if seed is not None:
        kw.update(seed=seed, volatile_frac=0.25, drift_every=200)
    return (dataclasses.replace(P.WORKLOADS[name], **kw),
            dataclasses.replace(J.WORKLOADS[name], **kw))


def test_presets_are_the_references():
    assert list(P.WORKLOADS) == list(J.WORKLOADS)
    for name in P.WORKLOADS:
        assert dataclasses.asdict(P.WORKLOADS[name]) == \
            dataclasses.asdict(J.WORKLOADS[name])
    assert dataclasses.asdict(P.LMARENA_LIKE) == \
        dataclasses.asdict(J.LMARENA_LIKE)
    assert dataclasses.asdict(P.SEARCH_LIKE) == \
        dataclasses.asdict(J.SEARCH_LIKE)


@pytest.mark.parametrize("name,seed", CASES)
def test_generate_trace_is_bit_identical(name, seed):
    ps, js = _specs(name, seed)
    got, want = P.generate_trace(ps), J.generate_trace(js)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    if seed is not None:
        assert got["volatile"].any()


@pytest.mark.parametrize("name,seed", CASES)
def test_build_benchmark_is_bit_identical(name, seed):
    ps, js = _specs(name, seed)
    got = P.build_benchmark(ps, history_frac=0.25, coverage=0.5)
    want = J.build_benchmark(js, history_frac=0.25, coverage=0.5)
    assert got.n_history == want.n_history
    for f in ("static_emb", "static_cls", "eval_emb", "eval_cls",
              "eval_key", "eval_volatile"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f


@pytest.mark.parametrize("name", list(CUTS))
def test_tune_threshold_matches_jax(name):
    """The tuner's whole grid as one sweep through each simulator, on a
    2,000-request sample: the same t*."""
    ps, js = _specs(name, None)
    kw = dict(error_budget=0.02, sample=2000, capacity=256)
    got = P.tune_threshold(P.build_benchmark(ps), device="cpu", **kw)
    want = J.tune_threshold(J.build_benchmark(js), **kw)
    assert got == want
    assert got in [float(t) for t in np.arange(0.70, 0.97, 0.02)]

"""The port's example twins (``repro_torch.examples``) run in-process on
the CPU at reduced sizes through their ``main()``, each held to its own
check: Krites' static-origin rate above the baseline's at the same total
hit rate and the IVF path's decisions agreeing with the flat scan
(quickstart), static-origin rising behind the live engine
(serve_cached_llm), the top-k equal to the oracle's (recsys_retrieval)
and the loss falling (train_lm). Without ``--device cpu`` each asks for
the card and raises on a host without one."""
import pytest
import torch

from repro_torch.examples import (quickstart, recsys_retrieval,
                                  serve_cached_llm, train_lm)

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def test_quickstart_twin(capsys):
    r = quickstart.main(CPU, n_requests=4000, n_classes=600,
                        tier_rows=8192, n_queries=128)
    b, k = r["baseline"], r["krites"]
    assert k["static_origin_rate"] > b["static_origin_rate"] > 0
    assert k["promotions"] > 0 and b["promotions"] == 0
    # "unchanged" at the three decimals the reference prints
    assert abs(k["total_hit_rate"] - b["total_hit_rate"]) <= 1e-3
    assert r["agreement"] == 1.0
    out = capsys.readouterr().out
    assert "static-origin served fraction:" in out
    assert "decision agreement 1.000" in out


def test_serve_cached_llm_twin(capsys):
    r = serve_cached_llm.main(CPU, n_requests=100)
    b, k = r["baseline"], r["krites"]
    assert k["static_origin_rate"] > b["static_origin_rate"]
    assert k["approved"] > 0 and k["requests"] == b["requests"] == 100
    assert "static-origin: " in capsys.readouterr().out


def test_recsys_retrieval_twin(capsys):
    r = recsys_retrieval.main(CPU)
    assert not r["kernel"] and tuple(r["ids"].shape) == (4, 10)
    assert torch.equal(r["ids"], r["oracle_ids"])
    assert "== oracle (simsearch_ref): OK" in capsys.readouterr().out


def test_train_lm_twin(capsys):
    r = train_lm.main(CPU + ["--steps", "25", "--batch", "2", "--seq",
                             "32"])
    assert r["last"] < r["first"] - 0.3
    assert "OK: learning" in capsys.readouterr().out


def test_twins_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    for main in (quickstart.main, serve_cached_llm.main,
                 recsys_retrieval.main, train_lm.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])

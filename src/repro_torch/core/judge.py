"""Judges for VerifyAndPromote: structured verdicts + rewriters.

The paper's asynchronous judge emits promote-or-reject; TweakLLM
(PAPERS.md) adds a third outcome — *tailor the cached response to the
new prompt* — so the verdict is now a first-class type:

- ``Verdict``: outcome in {APPROVE, REJECT, REWRITE} + the tailored
  text (rewrite), a TTL verdict, and a confidence. ``bool(verdict)``
  is "approved" so verdicts drop into boolean call sites.
- ``as_verdict``: auto-wraps plain ``bool`` judge returns — every
  legacy injected judge callable keeps working unchanged.
- OracleJudge: ground-truth equivalence classes (the paper's §4 setup);
  an optional ``rewritable`` predicate upgrades would-be rejects to
  REWRITE (the oracle model of "a cheap rewriter can tailor this").
- NoisyOracleJudge: oracle + configurable false-approve/false-reject
  rates (the §5 verifier-fidelity analysis: added error <= eps*p_prom).
- LLMJudge: a real model-backed judge for the live end-to-end example —
  scores semantic equivalence; an optional ``rewrite_threshold`` opens
  a near-miss band [rewrite_threshold, threshold) that verdicts REWRITE.
- ``template_rewriter``: the deterministic reference ``RewriterFn``
  (prompt-tagged tailoring) the launchers and tests wire in; a real
  deployment substitutes a small LM.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

# verdict outcomes (string tags: they ride WAL records and snapshots)
APPROVE = "approve"
REJECT = "reject"
REWRITE = "rewrite"
OUTCOMES = (APPROVE, REJECT, REWRITE)

# RewriterFn protocol: (q_text, h_text, answer) -> tailored answer text.
# Runs OFF the critical path (pool worker thread), rate-budgeted like
# the judge; an empty return or an exception counts as rewrite_failed
# and the verdict downgrades to REJECT.
RewriterFn = Callable[[str, str, str], str]


@dataclass(frozen=True)
class Verdict:
    """One judge decision. ``text`` is only meaningful for REWRITE (the
    tailored answer); ``ttl`` of None defers to the policy's freshness
    TTL assignment; ``confidence`` is advisory telemetry."""
    outcome: str = APPROVE
    text: str = ""
    ttl: Optional[int] = None
    confidence: float = 1.0

    def __post_init__(self):
        if self.outcome not in OUTCOMES:
            raise ValueError(f"unknown verdict outcome {self.outcome!r}")

    @property
    def approved(self) -> bool:
        return self.outcome == APPROVE

    def __bool__(self) -> bool:
        # verdicts drop into legacy boolean call sites: truthy == "this
        # exact cached answer is approved as-is"
        return self.outcome == APPROVE


def as_verdict(result) -> Verdict:
    """Auto-wrap a judge return: plain bools (every pre-verdict judge
    callable) become APPROVE/REJECT verdicts; Verdicts pass through."""
    if isinstance(result, Verdict):
        return result
    return Verdict(APPROVE if result else REJECT)


def template_rewriter(q_text: str, h_text: str, answer: str) -> str:
    """Reference rewriter: deterministically tailor the cached answer to
    the new prompt by prefixing the prompt context — the cheapest
    possible stand-in for TweakLLM's small-model rewrite, sufficient for
    the demo launchers and for provenance tests (the output differs from
    the cached answer and embeds the triggering prompt)."""
    return f"[tailored to: {q_text}] {answer}" if q_text else str(answer)


class OracleJudge:
    """approve iff query and static neighbor share an equivalence class.

    The paper's judge is defined over the ``(q_text, h_text, answer)``
    triple — the class-id comparison is the oracle shortcut the
    simulator uses. The live serving path now plumbs the real texts
    into every grey-zone payload (``KritesPolicy(static_texts=)``);
    ``require_texts=True`` makes this judge refuse payloads that lost
    them (used by tests and the verifier-fidelity benchmark to pin the
    contract).

    ``rewritable(q_cls, h_cls, q_text, h_text) -> bool`` (optional)
    is the oracle's rewrite model: a pair that fails the equivalence
    test but passes the predicate verdicts REWRITE instead of REJECT
    (mirrors the simulator's per-request ``rewritable`` channel).
    """

    def __init__(self, require_texts: bool = False, freshness=None,
                 rewritable: Optional[Callable] = None):
        self.require_texts = require_texts
        # a core.freshness.FreshnessPolicy; when given, this judge also
        # emits a per-entry TTL verdict alongside every approval
        self.freshness = freshness
        self.rewritable = rewritable

    def __call__(self, q_cls: int, h_cls: int, q_text: str = "",
                 h_text: str = "", answer: str = "") -> Verdict:
        if self.require_texts and not (q_text and h_text and answer):
            raise ValueError(
                f"judge payload missing verification texts: "
                f"q_text={q_text!r} h_text={h_text!r} answer={answer!r}")
        if int(q_cls) == int(h_cls):
            return Verdict(APPROVE)
        if self.rewritable is not None \
                and self.rewritable(q_cls, h_cls, q_text, h_text):
            return Verdict(REWRITE)
        return Verdict(REJECT)

    def assign_ttl(self, q_text: str = "", h_text: str = "",
                   answer: str = "") -> int:
        """TTL verdict for an approved promotion (DESIGN.md §16): how
        many request ticks the promoted entry should live, judged from
        the query's staleness-risk class (0 = unbounded). The verdict
        rides the promotion payload into the WAL and the dynamic
        tier's ``expires_at`` column."""
        if self.freshness is None:
            return 0
        return int(self.freshness.ttl_for_text(q_text or h_text))


@dataclass
class NoisyOracleJudge:
    """Oracle with false-approve rate eps_fa and false-reject rate eps_fr.

    Deterministic per (q, h) pair (hash-seeded), so dedup/retry behave
    like a real, consistent judge rather than a coin flip per call.
    """
    eps_fa: float = 0.0
    eps_fr: float = 0.0
    seed: int = 0

    def __call__(self, q_cls: int, h_cls: int, q_text: str = "",
                 h_text: str = "", answer: str = "") -> Verdict:
        truth = int(q_cls) == int(h_cls)
        h = hashlib.blake2s(
            f"{self.seed}|{q_cls}|{h_cls}|{q_text}|{h_text}".encode(),
            digest_size=8).digest()
        u = int.from_bytes(h, "little") / 2**64
        approve = (u >= self.eps_fr) if truth else (u < self.eps_fa)
        return Verdict(APPROVE if approve else REJECT)


class LLMJudge:
    """Model-backed judge for the live stack.

    ``score_fn(q_text, h_text, answer) -> float`` returns an equivalence
    score in [0, 1]; approve when >= threshold. The e2e example wires this
    to the tiny-LM scorer in serving/llm_judge_backend.py.

    ``rewrite_threshold`` (optional, < threshold) opens the TweakLLM
    near-miss band: scores in [rewrite_threshold, threshold) verdict
    REWRITE — close enough that a cheap rewriter can tailor the cached
    answer, not close enough to serve as-is.
    """

    def __init__(self, score_fn: Callable[[str, str, str], float],
                 threshold: float = 0.5,
                 rewrite_threshold: Optional[float] = None):
        if rewrite_threshold is not None \
                and not rewrite_threshold < threshold:
            raise ValueError(
                f"rewrite_threshold {rewrite_threshold} must be below "
                f"threshold {threshold}")
        self.score_fn = score_fn
        self.threshold = threshold
        self.rewrite_threshold = rewrite_threshold

    def __call__(self, q_cls: int, h_cls: int, q_text: str = "",
                 h_text: str = "", answer: str = "") -> Verdict:
        s = float(self.score_fn(q_text, h_text, answer))
        if s >= self.threshold:
            return Verdict(APPROVE, confidence=s)
        if self.rewrite_threshold is not None \
                and s >= self.rewrite_threshold:
            return Verdict(REWRITE, confidence=s)
        return Verdict(REJECT, confidence=s)

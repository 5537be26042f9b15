"""Three-term roofline of one step on one NVIDIA H100 (port of
``repro/analysis/roofline.py``).

The card's peaks are fields with defaults, the spec-sheet peaks of an
"NVIDIA H100 80GB HBM3, 700.00 W" (NVIDIA's data sheet, SXM part,
dense rates without sparsity): 3.35e12 B/s of HBM; 989e12 FLOP/s in
bf16 and 494.5e12 in TF32 on the tensor cores, 67e12 in fp32 outside
them; and 450e9 B/s a direction of NVLink for the collective term. A
card set below 700 W runs slower under load, so a measured time is
read beside its card's power limit.

Terms (seconds a step on one card; the counts are per card):
    compute    = flops / peak of the workload's compute dtype
    memory     = bytes / hbm_bw
    collective = collective operand bytes / link_bw

The compute dtype is the type of the workload's products: LM cells
are bf16; recsys and GNN run fp32 with TF32 off (the parity contract),
so their compute term divides by the fp32 peak. The cache lookup's
product is the simsearch kernel's TF32 screen on the tensor cores (its
exact fp32 rescore of the few screened candidates depends on the data
and is not counted), so it divides by the TF32 peak.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

HBM_BW = 3.35e12                      # B/s
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 494.5e12,
              "float32": 67e12}                   # FLOP/s, dense
LINK_BW = 450e9                       # B/s a direction, NVLink
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"   # what the peaks are for


def bound(bytes_moved: float, flops: float, dtype: str,
          hbm_bw: float = HBM_BW, peak_flops: Dict[str, float] | None = None):
    """(bound_ms, bound_by) of one kernel call: the larger of the bytes
    it must move (each input read once, each output written once) over
    the HBM rate and its operations over the card's peak for ``dtype``;
    ``bound_by`` is ``"bytes"`` or ``"operations"``."""
    peaks = PEAK_FLOPS if peak_flops is None else peak_flops
    t_bytes = bytes_moved / hbm_bw
    t_ops = flops / peaks[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


@dataclass
class Roofline:
    name: str
    chips: int
    hlo_flops: float          # per-card program flops (counted)
    hlo_bytes: float          # per-card bytes moved (modelled)
    coll_bytes: float         # per-card collective operand bytes
    model_flops: float        # 6ND-style useful flops (global)
    compute_dtype: str = "bfloat16"
    peak_flops: Dict[str, float] = field(
        default_factory=lambda: dict(PEAK_FLOPS))
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bound: str = ""
    useful_ratio: float = 0.0  # model_flops / (hlo_flops * chips)
    step_s: float = 0.0        # max of the three terms
    roofline_frac: float = 0.0  # useful compute time / bound term

    @property
    def peak(self) -> float:
        return self.peak_flops[self.compute_dtype]

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops / self.peak
        self.memory_s = self.hlo_bytes / self.hbm_bw
        self.collective_s = self.coll_bytes / self.link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bound = max(terms, key=terms.get)
        self.step_s = terms[self.bound]
        total = self.hlo_flops * self.chips
        self.useful_ratio = self.model_flops / total if total else 0.0
        ideal = self.model_flops / (self.chips * self.peak)
        self.roofline_frac = ideal / self.step_s if self.step_s else 0.0
        return self

    def to_dict(self) -> Dict:
        return asdict(self)


def from_counts(name: str, record, model_flops: float, chips: int = 1,
                compute_dtype: str = "bfloat16") -> Roofline:
    """The counterpart of the reference's ``from_compiled``: a roofline
    from a :class:`counter.ProgramCounter` that traced one call (its
    counted flops, the bytes its arguments, outputs and temporaries
    hold, and its collective operand bytes)."""
    mem = memory_summary(record)
    return Roofline(
        name=name, chips=chips, hlo_flops=float(record.flops()),
        hlo_bytes=mem["argument_size_in_bytes"]
        + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"],
        coll_bytes=float(record.collective_bytes().get("total", 0)),
        model_flops=model_flops, compute_dtype=compute_dtype).finalize()


def memory_summary(record) -> Dict[str, float]:
    """The reference's memory keys from a traced call: arguments,
    outputs, temporaries (the peak of the bytes the call made beyond
    its outputs), outputs that alias arguments, and ``peak_bytes_est``
    = args + temps + (outputs - aliased)."""
    out = {k: float(v) for k, v in record.memory().items()}
    out["peak_bytes_est"] = (out["argument_size_in_bytes"]
                             + out["temp_size_in_bytes"]
                             + max(out["output_size_in_bytes"]
                                   - out["alias_size_in_bytes"], 0.0))
    return out

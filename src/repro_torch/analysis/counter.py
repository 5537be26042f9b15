"""Count a workload's program by tracing one call of it (the port's
stand-in for ``repro/analysis/hlo_parse.py`` and XLA's
``cost_analysis`` / ``memory_analysis``).

Mechanism: :class:`ProgramCounter` is one ``TorchDispatchMode``
(``torch.utils._python_dispatch``). While it is active, every ATen op
the call runs passes through it, the autograd backward's too; run on
``meta`` tensors, the call allocates nothing and computes nothing, so a
full-size cell is counted on a host without a card. It records:

(a) matmul FLOPs, by the formulas ``torch.utils.flop_counter`` registers
    (mm, addmm, bmm, baddbmm, convolutions, SDPA). Einsums reach it as
    bmm. Elementwise work is not counted; XLA's ``cost_analysis`` counts
    it, so the two differ by that work;
(b) the hand-written kernels' costs: a kernel's meta branch (its
    ``kernel.py``) reports its FLOPs and bytes from ``kernel_costs`` by
    :func:`record_kernel`. The counter adds the FLOPs to (a);
(c) collectives: every ``_c10d_functional`` and ``c10d`` collective,
    under the reference's kind names (:data:`COLLECTIVES`), with its
    operand bytes (the bytes entering the collective on this rank), read
    as :meth:`ProgramCounter.collective_bytes` and
    :meth:`ProgramCounter.count_collectives` in the reference's dict
    shapes. Zero on one card;
(d) live bytes: each op output's storage is added when it is created
    and subtracted when it is freed (``weakref.finalize`` on its untyped
    storage). With the call's arguments and outputs named
    (:meth:`ProgramCounter.run`), this gives XLA's argument, output,
    alias and temporary sizes and the peak.

A DTensor program (``distributed/``, a mesh of ``torch.distributed``
ranks) is counted per rank, as the reference's ``cost_analysis`` counts
one device of its SPMD program: the hook returns ``NotImplemented`` for
an op with a DTensor among its types (as ``torch``'s own
``CommDebugMode`` does), so DTensor first turns it into the rank's local
ops and the collectives it issues, and those come back through the hook
on plain tensors; what DTensor's shape propagation runs under its fake
mode, on global shapes, is passed over. So a DTensor call counts its
matmul FLOPs at the local shapes, its kernels' meta branches on the
local shards, the live bytes of the local storages and the collectives
DTensor and the port's own ``_c10d_functional`` calls issue, under
their ``_c10d_functional`` names. Run under a ``"fake"`` process group
(``launch/dryrun.py``), this is rank 0's program of a 256- or 512-rank
mesh, on one host. DTensor's Shard-to-Shard exchange is one all-to-all
on cards (``_dtensor.shard_dim_alltoall``); on a ``cpu``-typed mesh, as
the fake group's is, DTensor would fall back to an all-gather and a
chunk (gloo has no all-to-all). While the counter is active, meta
tensors take the cards' path there too, so the exchange is counted as
one all-to-all of the rank's shard, with no gathered buffer in the
peak.

Unlike XLA's numbers, these are the eager program's: every op runs as
written (no fusion, no buffer reuse beyond the caching allocator's), so
the peak is what the card's allocator would hold, less its rounding and
what a library kernel allocates for itself.
"""
from __future__ import annotations

import importlib
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op (overload packet name) -> (kind, index of the operand argument)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}


# DTensor's Shard-to-Shard exchange: defined in ``_collective_utils``,
# called through ``placement_types``' own reference to it
_ALLTOALL_HOMES = ("torch.distributed.tensor.placement_types",
                   "torch.distributed.tensor._collective_utils")


def _as_on_cards(real: Callable) -> Callable:
    """DTensor's ``shard_dim_alltoall`` (``real``) as it runs on cards,
    one ``_dtensor.shard_dim_alltoall`` op, also for meta tensors on a
    ``cpu``-typed mesh, where DTensor would fall back to an all-gather
    and a chunk; real tensors keep DTensor's own path."""
    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or input.device.type != "meta":
            return real(input, gather_dim, shard_dim, mesh, mesh_dim)
        import torch.distributed._functional_collectives as funcol
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    return shard_dim_alltoall


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The plain tensors of ``tree``; a DTensor's local shard stands for
    it (what this rank holds)."""
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _storages(tree) -> Dict[int, int]:
    """{storage key: nbytes} of the distinct storages in ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``: how a
    call's arguments and outputs are sized."""
    return sum(_storages(tree).values())


def record_kernel(name: str, flops: float, nbytes: float,
                  dtype: str) -> None:
    """Report one hand-written kernel call (its meta branch) to every
    active :class:`ProgramCounter`."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, ProgramCounter):
            mode._kernel(name, flops, nbytes, dtype)


class ProgramCounter(TorchDispatchMode):
    """Count one call: ``counter.run(fn, *args)`` traces ``fn(*args)``
    and returns its output; or ``with ProgramCounter() as c:`` around
    any code (arguments and outputs then unnamed). See the module
    docstring for what it records."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.ops: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0])
        self._coll_bytes: Dict[str, int] = defaultdict(int)
        self._coll_counts: Dict[str, int] = defaultdict(int)
        self._live: Dict[int, int] = {}      # storages made inside the call
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args: Dict[int, int] = {}
        self._outs: Dict[int, int] = {}
        self._patched: list = []

    def __enter__(self):
        for name in _ALLTOALL_HOMES:
            mod = importlib.import_module(name)
            real = getattr(mod, "shard_dim_alltoall", None)
            if real is not None:
                setattr(mod, "shard_dim_alltoall", _as_on_cards(real))
                self._patched.append((mod, real))
        return super().__enter__()

    def __exit__(self, *exc):
        while self._patched:
            mod, real = self._patched.pop()
            setattr(mod, "shard_dim_alltoall", real)
        return super().__exit__(*exc)

    # -- the dispatch hook ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # counted as the local ops it becomes
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out   # DTensor's shape propagation: no work of the rank
        packet = func._overloadpacket
        if str(packet) == "_dtensor.shard_dim_alltoall" and \
                out.untyped_storage().nbytes() > \
                out.numel() * out.element_size():
            out = out.clone()  # its meta version returns a view of a
            #                    gathered buffer; cards write one its size
        row = self.ops[str(packet)]
        row[0] += 1
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.matmul_flops += f
            row[1] += f
        coll = _COLLECTIVE_OPS.get(str(packet))
        if coll is not None:
            kind, i = coll
            self._coll_bytes[kind] += sum(
                t.numel() * t.element_size() for t in _tensors(args[i]))
            self._coll_counts[kind] += 1
        for t in _tensors(out):
            row[2] += self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> int:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0           # a tensor without storage
        key = st._cdata
        if key in self._live or key in self._args:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _kernel(self, name, flops, nbytes, dtype) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0, "dtype": dtype})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)

    # -- running one call ----------------------------------------------
    def run(self, fn: Callable, *args) -> Any:
        """``fn(*args)`` under the counter, the storages of ``args``
        named as the call's arguments and those of its result as its
        outputs. Returns the result."""
        self._args = _storages(args)
        with self:
            out = fn(*args)
        self._outs = _storages(out)
        return out

    # -- reading -------------------------------------------------------
    def kernel_flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    def flops(self) -> float:
        """Matmul FLOPs (a) plus the hand-written kernels' FLOPs (b)."""
        return self.matmul_flops + self.kernel_flops()

    def collective_bytes(self) -> Dict[str, int]:
        """{kind: operand bytes} for the kinds seen, plus ``"total"``:
        the shape of ``hlo_parse.collective_bytes``."""
        out = {k: v for k, v in self._coll_bytes.items()}
        out["total"] = sum(out.values())
        return out

    def count_collectives(self) -> Dict[str, int]:
        """{kind: calls} for every kind: the shape of
        ``hlo_parse.count_collectives``."""
        return {c: self._coll_counts.get(c, 0) for c in COLLECTIVES}

    def memory(self) -> Dict[str, int]:
        """XLA's ``memory_analysis`` sizes: arguments; outputs (all of
        them) and those that alias arguments; temporaries = the peak of
        the bytes made inside the call less its outputs made there, so
        that args + temps + (outputs - aliased) is the call's peak."""
        args = sum(self._args.values())
        outs = sum(self._outs.values())
        alias = sum(n for k, n in self._outs.items() if k in self._args)
        return {"argument_size_in_bytes": args,
                "output_size_in_bytes": outs,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": max(
                    self.peak_bytes - (outs - alias), 0)}

    def op_table(self) -> list:
        """One row an op, by calls: {"op", "calls", "flops",
        "out_bytes"} (the counterpart of the reference's saved HLO)."""
        return [{"op": name, "calls": c, "flops": f, "out_bytes": b}
                for name, (c, f, b) in sorted(
                    self.ops.items(), key=lambda kv: -kv[1][0])]

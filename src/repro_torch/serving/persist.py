"""Snapshot/restore of the serving state: both tiers, their ANN
indexes, and the policy's host mirrors (port of
``repro/serving/persist.py``, DESIGN.md §14).

The on-disk format is the reference's (``distributed/checkpoint.py``:
``step_<N>/manifest.json`` plus one blake2s-hashed ``.npy`` per leaf,
published by an atomic tmp-dir rename), so a snapshot written by either
package restores into the other:

- **dynamic tier** — all eight tier columns (``expires_at`` included),
  the six host decision mirrors (rewrite provenance included), the
  answer list and the logical clock ``t``; entries already past their
  expiry at the captured clock are swept on restore;
- **L1 front tier** — rides in the manifest (``extra["l1"]``) and is
  reinstalled through ``ExactTier.load_state``;
- **adaptive controller** — window arrays in the leaf tree, counters,
  rng and thresholds in the manifest;
- **static IVF index** — the packed layout (centroids, int8 codes,
  scales, row ids) without its corpus, which is the static tier's rows,
  with the corpus hash it was built from. Restore re-wires the layout to
  the live tier through ``index/ivf.ivf_from_numpy`` when that hash
  matches (**warm restore**, no k-means); a stale or absent layout is
  rebuilt inline or on a background thread that swaps
  ``policy.index`` when done;
- **segmented dynamic index** — rebuilt from the restored live set via
  ``SegmentedIndex.bulk_load``;
- **WAL cursor** — ``wal_seq`` at capture time (under ``dyn_lock``);
  recovery replays only journal records after it
  (``promo_wal.replay_into(skip=...)``).

The manifest is versioned (``format``); loaders refuse snapshots they
do not understand instead of misreading them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import checkpoint as ckpt

SNAP_FORMAT = 4            # 4: + rewrite provenance mirror
SNAP_FORMATS = (1, 2, 3, 4)   # formats the loader understands
SNAP_KIND = "krites-snapshot"


def state_hash(arr) -> str:
    """Content hash used to tie an index to the corpus it was built
    from (and snapshots to their static tier); a tensor is hashed from
    its host copy, so equal contents hash equal in either package. A
    sequence of row blocks (a sharded tier's) is hashed a block at a
    time, in order, and hashes as the tensor of its rows would."""
    if isinstance(arr, (tuple, list)):
        h = hashlib.blake2s(digest_size=16)
        for block in arr:
            h.update(np.ascontiguousarray(ckpt._host(block)).tobytes())
        return h.hexdigest()
    return ckpt._hash(np.ascontiguousarray(ckpt._host(arr)))


def _jsonable(x: Any) -> Any:
    """Answers are strings in every shipped backend; anything exotic is
    coerced so a snapshot never fails mid-write."""
    return x if isinstance(x, (str, int, float, bool)) or x is None \
        else str(x)


def _tier_fields() -> list:
    from repro_torch.core.tiers import DynamicTier
    return [f.name for f in dataclasses.fields(DynamicTier)]


def _host_column(tier, field: str) -> np.ndarray:
    """A host copy of one dynamic-tier column: the tensor, or under a
    mesh the per-shard blocks of the ``ShardedDynamicTier`` in slot
    order."""
    col = getattr(tier, field)
    if isinstance(col, torch.Tensor):
        return col.to("cpu", copy=True).numpy()
    return np.concatenate([p.to("cpu", copy=True).numpy() for p in col])


@dataclass
class Snapshot:
    """A loaded snapshot: raw arrays (nested dict) + manifest extras."""
    step: int
    tree: dict
    extra: dict
    path: Path


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_snapshot(snap_dir: str | Path, policy, *, step: Optional[int] = None,
                  include_static: bool = True) -> Path:
    """Capture the policy's full serving state and publish it atomically.

    The capture (device->host copy of the dynamic tier, mirror copies,
    ``wal_seq``) happens under ``dyn_lock``, so it is a consistent cut
    with respect to concurrent promotions; the disk write happens after
    the lock is released, on the copies. The WAL is fsynced inside the
    cut, so ``wal_seq`` counts only durable records.
    """
    snap_dir = Path(snap_dir)
    if step is None:
        last = latest_snapshot(snap_dir)
        step = 0 if last is None else last + 1

    with policy.dyn_lock:
        wal = getattr(policy, "wal", None)
        if wal is not None:
            wal.sync()
        wal_seq = wal.seq if wal is not None else 0
        # copies, on the CPU too: the tier is updated in place
        dyn = {f: _host_column(policy.dyn, f) for f in _tier_fields()}
        mirrors = {
            "valid": policy._valid_np.copy(),
            "last_used": policy._last_used_np.copy(),
            "static_origin": policy._static_origin_np.copy(),
            "written_at": policy._written_at_np.copy(),
            "expires_at": policy._expires_np.copy(),
            "rewritten": policy._rewritten_np.copy(),
        }
        t = policy.t
        dyn_answers = [_jsonable(a) for a in policy.dyn_answers]
        l1 = getattr(policy, "l1", None)
        l1_state = l1.to_state() if l1 is not None else None
        adaptive = getattr(policy, "adaptive", None)
        adaptive_arrays = adaptive_scalars = None
        if adaptive is not None:
            adaptive_arrays, adaptive_scalars = adaptive.to_state()

    tree: dict = {"dyn": dyn, "mirrors": mirrors}
    if adaptive_arrays is not None:
        tree["adaptive"] = adaptive_arrays
    extra: dict = {
        "format": SNAP_FORMAT,
        "kind": SNAP_KIND,
        "saved_unix": time.time(),
        "t": int(t),
        "wal_seq": int(wal_seq),
        "capacity": int(policy.cfg.capacity),
        "d": int(dyn["emb"].shape[1]),
        "dyn_answers": dyn_answers,
        "l1": l1_state,
        "dyn_index": policy.describe_dyn_index()
        if policy.dyn_index is not None else None,
        "adaptive": adaptive_scalars,
        "ivf": None,
        "static_hash": None,
    }

    static = policy.static
    extra["static_hash"] = state_hash(static.emb)
    if include_static:
        emb = static.emb if isinstance(static.emb, torch.Tensor) \
            else np.concatenate([ckpt._host(p) for p in static.emb])
        tree["static"] = {"emb": emb, "cls": static.cls,
                          "answer_ref": static.answer_ref}
        extra["static_answers"] = [_jsonable(a)
                                   for a in policy.static_answers]
        extra["static_texts"] = list(policy.static_texts) \
            if policy.static_texts is not None else None

    ivf_index = _plain_ivf_index(policy.index)
    if ivf_index is not None:
        ivf = ivf_index.ivf
        tree["ivf"] = {"centroids": ivf.centroids, "codes": ivf.codes,
                       "scales": ivf.scales, "row_ids": ivf.row_ids}
        extra["ivf"] = {
            "nprobe": int(ivf_index.nprobe),
            "n_candidates": int(ivf_index.n_candidates),
            # the corpus is not duplicated on disk: it is the static
            # tier's rows, re-wired on load; this hash is what makes
            # staleness detectable (hashed once when it is the tier)
            "corpus_hash": extra["static_hash"]
            if ivf.corpus is static.emb else state_hash(ivf.corpus),
        }

    return ckpt.save(snap_dir, step, tree, extra=extra)


def _plain_ivf_index(index) -> Optional[object]:
    """The IVFIndex if that is what the policy serves through; a flat,
    sharded or absent index has nothing to persist (a sharded layout is
    mesh-shaped and is rebuilt from the corpus)."""
    from repro_torch.index.ivf import IVFIndex
    return index if isinstance(index, IVFIndex) else None


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def latest_snapshot(snap_dir: str | Path) -> Optional[int]:
    """Newest published snapshot step, ignoring torn tmp dirs (a crash
    mid-save leaves only ``.tmp_*``, which is never listed)."""
    return ckpt.latest_step(snap_dir)


def load_snapshot(snap_dir: str | Path, step: Optional[int] = None,
                  verify: bool = True) -> Snapshot:
    """Read a snapshot back into host arrays, hash-verifying each leaf.

    Raises ``FileNotFoundError`` when no snapshot exists, ``IOError``
    on corruption, ``ValueError`` on an unknown manifest format.
    """
    snap_dir = Path(snap_dir)
    if step is None:
        step = latest_snapshot(snap_dir)
        if step is None:
            raise FileNotFoundError(f"no snapshot under {snap_dir}")
    src = snap_dir / f"step_{step:08d}"
    manifest = json.loads((src / "manifest.json").read_text())
    extra = manifest.get("extra", {})
    if extra.get("format") not in SNAP_FORMATS \
            or extra.get("kind") != SNAP_KIND:
        raise ValueError(
            f"{src}: not a format-{SNAP_FORMATS} {SNAP_KIND} manifest "
            f"(got format={extra.get('format')!r} "
            f"kind={extra.get('kind')!r})")

    tree: dict = {}
    for name, meta in manifest["leaves"].items():
        arr = np.load(src / meta["file"])
        if verify and ckpt._hash(arr) != meta["hash"]:
            raise IOError(f"snapshot corruption in leaf {name}")
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return Snapshot(step=step, tree=tree, extra=extra, path=src)


def load_static_index(snap: "Snapshot | str | Path", corpus, *,
                      nprobe: Optional[int] = None,
                      n_candidates: Optional[int] = None):
    """Warm-restore the static IVF index against ``corpus`` (the live
    static tier's rows, a tensor: the layout goes to its device and
    shares it without a copy). Returns an ``IVFIndex`` ready to inject,
    or ``None`` when the snapshot carries no index or one built from a
    different corpus (stale: the caller rebuilds). ``nprobe`` /
    ``n_candidates`` override the snapshotted operating point."""
    from repro_torch.index.ivf import IVFIndex, ivf_from_numpy

    if not isinstance(snap, Snapshot):
        try:
            snap = load_snapshot(snap)
        except FileNotFoundError:
            return None
    meta = snap.extra.get("ivf")
    if meta is None or "ivf" not in snap.tree:
        return None
    if meta["corpus_hash"] != state_hash(corpus):
        return None                      # stale: corpus changed
    leaves = snap.tree["ivf"]
    dev = corpus.device if isinstance(corpus, torch.Tensor) else None
    ivf = ivf_from_numpy(leaves["centroids"], leaves["codes"],
                         leaves["scales"], leaves["row_ids"], corpus,
                         device=dev)
    return IVFIndex(ivf,
                    nprobe=meta["nprobe"] if nprobe is None else nprobe,
                    n_candidates=meta["n_candidates"]
                    if n_candidates is None else n_candidates)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def restore_policy(policy, snap: "Snapshot | str | Path", *,
                   step: Optional[int] = None,
                   rebuild: str = "background") -> dict:
    """Install a snapshot's serving state into a freshly constructed
    policy (same ``capacity``/``d`` as the saver; the dynamic tier and
    any injected ``dyn_index`` must be empty: restore replaces state, it
    does not merge).

    Static-index handling (``rebuild``): the snapshot's IVF layout is
    installed when its corpus hash matches the policy's static tier
    (warm restore). Otherwise, when the deployment uses an index (the
    policy carries an ``IVFIndex``, or the snapshot recorded one and the
    policy serves neither an index nor ``fused=``): ``"inline"``
    rebuilds before returning, ``"background"`` starts a thread that
    swaps ``policy.index`` when the build finishes (the report carries
    it, to be joined), ``"never"`` leaves the index alone.

    Returns a report: restored step/t/wal_seq, live-entry count, what
    happened to the index, and the rebuild thread (or None).
    """
    from repro_torch.core import tiers as T

    if rebuild not in ("background", "inline", "never"):
        raise ValueError(f"rebuild={rebuild!r}")
    if not isinstance(snap, Snapshot):
        snap = load_snapshot(snap, step=step)

    dyn_np = snap.tree["dyn"]
    cap, d = dyn_np["emb"].shape
    if cap != policy.cfg.capacity:
        raise ValueError(f"snapshot capacity {cap} != policy "
                         f"capacity {policy.cfg.capacity}")
    if int(snap.extra["t"]) < 0:
        raise ValueError("negative clock in snapshot")

    # format-1 snapshots predate per-entry expiry: default to "never"
    if "expires_at" not in dyn_np:
        dyn_np = dict(dyn_np, expires_at=np.zeros(cap, np.int32))
    # copies: the tier is updated in place, and a Snapshot's arrays may
    # restore more than one policy; under a mesh the tier is built on
    # the host and placed row-sharded on the policy's shards
    like = T.make_dynamic_tier(1, d, device="cpu")
    dyn = T.DynamicTier(**{
        f: torch.tensor(dyn_np[f], device=policy.device
                        if policy.mesh is None else "cpu",
                        dtype=getattr(like, f).dtype)
        for f in _tier_fields()})
    if policy.mesh is not None:
        from repro_torch.index.sharded import shard_dynamic_tier
        dyn = shard_dynamic_tier(dyn, policy.mesh)
    with policy.dyn_lock:
        policy.dyn = dyn
        m = snap.tree["mirrors"]
        policy._valid_np[:] = m["valid"]
        policy._last_used_np[:] = m["last_used"]
        policy._static_origin_np[:] = m["static_origin"]
        policy._written_at_np[:] = m["written_at"]
        policy._expires_np[:] = m.get("expires_at",
                                      np.zeros(cap, np.int64))
        # rewrite provenance (format 4); older snapshots carry it in the
        # answer_ref == -2 sentinel of the saved tier
        rw = m.get("rewritten")
        if rw is None:
            rw = (np.asarray(dyn_np["answer_ref"]) == -2) & m["valid"]
        policy._rewritten_np[:] = rw
        policy._ttl_active = bool((policy._expires_np > 0).any())
        policy.t = int(snap.extra["t"])
        answers = snap.extra.get("dyn_answers") or [None] * cap
        policy.dyn_answers = list(answers)
        if policy.dyn_index is not None:
            if policy.dyn_index.stats().get("writes", 0):
                raise ValueError(
                    "restore_policy needs a fresh dyn_index: the "
                    "segmented index is rebuilt from the restored "
                    "live set, not merged into existing state")
            live = np.nonzero(m["valid"])[0]
            if len(live):
                policy.dyn_index.bulk_load(live.astype(np.int32),
                                           dyn_np["emb"][live])
        # entries already past their expiry at the captured clock must
        # not resurrect: the policy's eager sweep kills them in the
        # tier, the mirrors and the dynamic index
        ttl_dropped = policy._sweep_expired_locked(policy.t)

    l1_restored = 0
    l1_state = snap.extra.get("l1")
    if getattr(policy, "l1", None) is not None and l1_state:
        l1_restored = policy.l1.load_state(l1_state, now=policy.t)

    adaptive_restored = False
    ad_scalars = snap.extra.get("adaptive")
    if getattr(policy, "adaptive", None) is not None \
            and ad_scalars and "adaptive" in snap.tree:
        with policy.dyn_lock:
            policy.adaptive.load_state(snap.tree["adaptive"], ad_scalars)
        adaptive_restored = True

    report = {
        "step": snap.step, "t": policy.t,
        "adaptive_restored": adaptive_restored,
        "wal_seq": int(snap.extra.get("wal_seq", 0)),
        "dyn_live": int(policy._valid_np.sum()),
        "ttl_dropped": int(ttl_dropped),
        "l1_restored": int(l1_restored),
        "index": "none", "rebuild_thread": None,
    }

    # -- static index: warm restore, else rebuild-and-swap ----------------
    # a sharded IVF layout is not snapshotted: a mesh's static index is
    # rebuilt from the corpus, as in the reference, and is kept here
    cur = _plain_ivf_index(policy.index) if policy.mesh is None else None
    wants_index = cur is not None \
        or (policy.index is None and policy.fused is None
            and policy.mesh is None and snap.extra.get("ivf") is not None)
    if not wants_index or rebuild == "never" and policy.index is not None:
        report["index"] = "kept" if policy.index is not None else "none"
        return report

    # keep the operator's live serving knobs over the snapshotted ones
    warm = load_static_index(
        snap, policy.static.emb,
        nprobe=cur.nprobe if cur is not None else None,
        n_candidates=cur.n_candidates if cur is not None else None)
    if warm is not None:
        policy.index = warm
        report["index"] = "warm"
        return report
    if rebuild == "never":
        report["index"] = "kept" if policy.index is not None else "none"
        return report

    report["index"] = f"rebuild-{rebuild}"
    ivf_meta = snap.extra.get("ivf") or {}
    nprobe = cur.nprobe if cur is not None \
        else ivf_meta.get("nprobe", 8)
    n_candidates = cur.n_candidates if cur is not None \
        else ivf_meta.get("n_candidates", 32)

    def _build_and_swap():
        from repro_torch.index.ivf import IVFIndex, build_ivf
        ivf = build_ivf(policy.static.emb, corpus_normalized=True)
        # atomic swap: attribute assignment is atomic under the GIL,
        # and every serve reads `policy.index` once per lookup
        policy.index = IVFIndex(ivf, nprobe=nprobe,
                                n_candidates=n_candidates)

    if rebuild == "inline":
        _build_and_swap()
    else:
        th = threading.Thread(target=_build_and_swap, daemon=True,
                              name="persist-index-rebuild")
        th.start()
        report["rebuild_thread"] = th
    return report

"""Write-ahead promotion journal (DESIGN.md §14).

A copy of the reference's ``repro/core/promo_wal.py`` (numpy only),
less one fault: :func:`compact` keeps the journal's numbering when it
drops every record (see its docstring). Frames and records are
byte-identical to the reference's.

The async VerifyAndPromote pipeline pays for a judge call and then
mutates only process memory: a crash between the verdict and the
promotion upsert silently discards verified work, and a crash right
after it loses the promotion entirely unless a full snapshot happens to
follow. The WAL closes that window. ``KritesPolicy`` (``wal=``) appends
each *approved* verdict to the journal **before** applying the upsert;
on restart the journal is replayed through the very same
``_promote`` path, so recovery rides the existing idempotence + LWW
(``written_at``) contract of ``tiers.upsert`` instead of a parallel
code path:

- **replay is idempotent** — re-promoting a journaled record finds its
  own near-duplicate key (sim >= 0.9999) and rewrites the identical
  fields (``written_at`` equals the record's ``enq_t``; ``last_used``
  is the policy's live clock, constant across back-to-back replays),
  so N replays produce the state of one;
- **replay is LWW-safe** — a journaled promotion whose key already
  holds a *newer* entry (``written_at > enq_t``) is skipped exactly
  like a live slow-judge straggler would be;
- **any prefix is a valid journal** — records are length+CRC framed,
  the reader stops at the first torn or corrupt frame (a crash mid-
  append), and replaying a prefix simply recovers fewer promotions.

Snapshots (``serving/persist.py``) record the journal's sequence number
(``wal_seq``) at capture time; recovery replays only the suffix, so a
promotion journaled before the snapshot can never clobber the LRU
clocks the snapshot already captured.

Durability is fsync-batched (``fsync_every`` appends or
``fsync_interval_s``, whichever first): the default trades a bounded
tail of the newest verdicts for not paying an fsync per promotion;
``fsync_every=1`` gives strict append-before-apply durability (the
fault-injection tests run there).

File format (little-endian)::

    header   b"PWAL" + u32 version (1)
    record   u32 payload_len | u32 crc32(payload) | payload
    payload  JSON: {seq, h_idx, enq_t, ttl, v(base64 fp32 bytes),
                    q_text, h_text, outcome, rewritten, q_cls}

The embedding travels as raw float32 bytes (base64) so replayed keys
are bit-identical to the promoted ones — the dedup test is an exact
similarity threshold, and a decimal round-trip could move a key across
it. ``q_text``/``h_text`` ride along for auditability (what was
verified), not for replay.
"""
from __future__ import annotations

import base64
import json
import os
import struct
import threading
import time
import zlib
from pathlib import Path

import numpy as np

MAGIC = b"PWAL"
VERSION = 1
_HEADER = struct.Struct("<4sI")
_FRAME = struct.Struct("<II")


def encode_record(v: np.ndarray, h_idx: int, enq_t: int, *, ttl: int = 0,
                  q_text: str = "", h_text: str = "", seq: int = 0,
                  outcome: str = "approve", rewritten: str = "",
                  q_cls: int = -1) -> dict:
    """Journal record for one promoting verdict (see module docstring).

    ``outcome``/``rewritten``/``q_cls`` (DESIGN.md §18) carry REWRITE
    provenance: replay must reconstruct the tailored answer text and
    the query-class key, neither of which is derivable from the static
    tier. Absent fields (journals written before the verdict refactor)
    default to a plain approval — old journals replay unchanged."""
    v = np.ascontiguousarray(v, np.float32)
    return {
        "seq": int(seq),
        "h_idx": int(h_idx),
        "enq_t": int(enq_t),          # == the promotion's written_at
        "ttl": int(ttl),
        "v": base64.b64encode(v.tobytes()).decode("ascii"),
        "q_text": q_text,
        "h_text": h_text,
        "outcome": str(outcome),
        "rewritten": str(rewritten),
        "q_cls": int(q_cls),
    }


def decode_vector(record: dict) -> np.ndarray:
    """Bit-exact fp32 embedding back out of a journal record."""
    return np.frombuffer(base64.b64decode(record["v"]), np.float32).copy()


class PromotionWAL:
    """Append-only, CRC-framed promotion journal with batched fsync.

    Thread-safe: appends arrive from judge-pool workers (inside
    ``KritesPolicy._promote`` under ``dyn_lock``) and from shutdown
    hooks. Opening an existing file scans it, adopts the valid prefix
    (continuing ``seq`` from it) and truncates any torn tail left by a
    crash mid-append, so the next append never corrupts the frame
    stream.
    """

    def __init__(self, path: str | Path, *, fsync_every: int = 8,
                 fsync_interval_s: float = 0.05):
        self.path = Path(path)
        self.fsync_every = max(1, int(fsync_every))
        self.fsync_interval_s = fsync_interval_s
        self._lock = threading.Lock()
        self._pending = 0             # appends since the last fsync
        self._last_sync = time.monotonic()
        self._appended = 0            # this process's appends (telemetry)
        self._synced_seq = 0          # records known durable
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self.path.exists():
            records, _, valid_bytes = scan_wal(self.path)
            # continue from the highest stamped seq — after a compact()
            # the file holds fewer records than history positions
            self._seq = max([int(r.get("seq", 0)) for r in records]
                            + [len(records)])
            self._synced_seq = self._seq
            self._f = open(self.path, "r+b")
            if valid_bytes < _HEADER.size:      # empty or foreign file
                self._f.truncate(0)
                self._f.seek(0)
                self._f.write(_HEADER.pack(MAGIC, VERSION))
                self._f.flush()
                os.fsync(self._f.fileno())
            else:
                self._f.truncate(valid_bytes)   # drop any torn tail
                self._f.seek(valid_bytes)
        else:
            self._seq = 0
            self._f = open(self.path, "w+b")
            self._f.write(_HEADER.pack(MAGIC, VERSION))
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- producer ----------------------------------------------------------

    @property
    def seq(self) -> int:
        """Records in the journal (preexisting + appended)."""
        with self._lock:
            return self._seq

    def append(self, record: dict) -> int:
        """Frame + append one record; returns its 1-based seq. The
        record's ``seq`` field is stamped here (append order is the
        replay order)."""
        with self._lock:
            self._seq += 1
            record = dict(record, seq=self._seq)
            payload = json.dumps(record, separators=(",", ":"),
                                 sort_keys=True).encode()
            self._f.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
            self._f.write(payload)
            self._appended += 1
            self._pending += 1
            now = time.monotonic()
            if self._pending >= self.fsync_every \
                    or now - self._last_sync >= self.fsync_interval_s:
                self._sync_locked()
            return self._seq

    def sync(self) -> None:
        """Force-flush + fsync everything appended so far."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._pending = 0
        self._synced_seq = self._seq
        self._last_sync = time.monotonic()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._sync_locked()
                self._f.close()

    def stats(self) -> dict:
        with self._lock:
            return {"seq": self._seq, "appended": self._appended,
                    "synced_seq": self._synced_seq,
                    "pending_fsync": self._pending}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader / replay
# ---------------------------------------------------------------------------

def scan_wal(path: str | Path) -> tuple[list[dict], bool, int]:
    """Read a journal tolerantly.

    Returns ``(records, clean, valid_bytes)``: every record of the
    longest valid prefix, whether the file ended exactly at a frame
    boundary with no damage (``clean``), and the byte offset that
    prefix ends at. A torn final frame (crash mid-append), a CRC
    mismatch, or undecodable JSON stops the scan — never raises — so
    any crash leaves a journal whose readable prefix is still a valid
    journal (prefix-crash safety, test-pinned).
    """
    path = Path(path)
    records: list[dict] = []
    data = path.read_bytes()
    if len(data) < _HEADER.size:
        return records, False, 0
    magic, version = _HEADER.unpack_from(data, 0)
    if magic != MAGIC or version != VERSION:
        return records, False, 0
    off = _HEADER.size
    clean = True
    while off < len(data):
        if off + _FRAME.size > len(data):
            clean = False
            break
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + length
        if end > len(data) or zlib.crc32(data[start:end]) != crc:
            clean = False
            break
        try:
            rec = json.loads(data[start:end])
        except ValueError:
            clean = False
            break
        records.append(rec)
        off = end
    return records, clean, off if not clean else len(data)


def read_wal(path: str | Path) -> tuple[list[dict], bool]:
    """(records of the longest valid prefix, file-was-clean)."""
    records, clean, _ = scan_wal(path)
    return records, clean


def replay_into(policy, path: str | Path, *, skip: int = 0) -> dict:
    """Replay a journal through ``policy._promote`` (journal=False so
    replay never re-appends). ``skip`` drops records with
    ``seq <= skip`` — the ``wal_seq`` a snapshot captured, whose
    effects (and any later LRU touches on them) the snapshot already
    holds. Matching on the stamped ``seq`` (not file position) keeps a
    snapshot's cursor valid across :func:`compact`. Safe to call any
    number of times: replay rides the upsert idempotence/LWW contract
    (module docstring). Returns counters for telemetry/tests."""
    records, clean = read_wal(path)
    replayed = skipped = 0
    for i, rec in enumerate(records):
        if int(rec.get("seq", i + 1)) <= skip:
            skipped += 1
            continue
        # the record's TTL verdict (0 = unbounded) reconstructs the same
        # expires_at on replay: expiry anchors at enq_t, which is here.
        # Outcome/rewritten/q_cls default to a plain approval so
        # pre-verdict journals replay bit-identically.
        policy._promote({"v": decode_vector(rec),
                         "h_idx": int(rec["h_idx"]),
                         "enq_t": int(rec["enq_t"]),
                         "ttl": int(rec.get("ttl", 0)),
                         "outcome": rec.get("outcome", "approve"),
                         "rewritten": rec.get("rewritten", ""),
                         "judge_args": {"q_cls": int(rec.get("q_cls", -1))},
                         }, journal=False)
        replayed += 1
    return {"records": len(records), "skipped": skipped,
            "replayed": replayed, "clean": clean}


def compact(path: str | Path, *, keep_from_seq: int) -> int:
    """Rewrite the journal dropping records with seq <= keep_from_seq
    (all subsumed by a snapshot that captured ``wal_seq ==
    keep_from_seq``). Kept records keep their original ``seq`` — seq is
    a position in the journal's history, not in the file — so a
    snapshot's ``wal_seq`` stays a valid replay cursor across
    compactions. Atomic (tmp + rename). Returns the records kept past
    the cursor.

    When every record would go, the newest one stays in the file as an
    anchor: reopening the journal continues ``seq`` from the highest
    stamped seq, and a header-only file would restart it at 0, stamping
    the next append at or below the snapshot's cursor (so a later
    ``replay_into(skip=cursor)`` would skip it). Replay skips the
    anchor (its seq <= the cursor), and the frames are unchanged, so
    the reference package reads the file as it is. The reference's
    ``compact`` writes the header-only file.

    Callers must quiesce appends (close or lock the live WAL) first;
    the launcher compacts right after its snapshot, inside the same
    shutdown/checkpoint section.
    """
    path = Path(path)
    records, _, _ = scan_wal(path)
    kept = [r for r in records if int(r.get("seq", 0)) > keep_from_seq]
    n_past = len(kept)
    if not kept and records:
        kept = [max(records, key=lambda r: int(r.get("seq", 0)))]
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION))
        for rec in kept:
            payload = json.dumps(rec, separators=(",", ":"),
                                 sort_keys=True).encode()
            f.write(_FRAME.pack(len(payload), zlib.crc32(payload)))
            f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return n_past

"""Write-ahead log + snapshot compaction for the fleet control plane.

The durability contract: every state mutation the control plane wants to
survive a crash is appended (seq-numbered, one JSON object per line) to
``wal.jsonl`` *before* the mutating request is acknowledged; a restarted
server loads ``snapshot.json`` and replays the records past it, arriving at
the exact pre-crash fleet state.  Compaction folds the log into a fresh
snapshot using the snapshot.py discipline — write ``snapshot.json.tmp.<pid>``,
``os.replace`` into place, *then* rewrite the log keeping only records
newer than the snapshot's ``last_seq`` — so every crash point leaves a
loadable pair:

* crash before the snapshot replace: old snapshot + full log (nothing lost);
* crash between the two replaces: new snapshot + the full log; replay
  skips records ``<= last_seq`` (they are idempotent against the snapshot
  that already contains them) and applies the rest;
* crash after the log replace: new snapshot + the preserved suffix.

The caller's state dump is not atomic with ongoing appends, so ``compact``
takes the seq the caller captured *before* dumping (``as_of_seq``): every
record acknowledged after that capture may be missing from the dump and
must survive in the rewritten log — stamping ``last_seq`` at compact time
instead would silently drop it.

Appends ``flush()`` to the OS page cache by default, which survives the
process being SIGKILLed (the failure mode the fleet lane induces); set
``fsync=True`` to also survive kernel/power loss at ~100x the write cost.
"""

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["WriteAheadLog"]


class WriteAheadLog:
    """Single-writer append-only log with snapshot compaction (thread-safe)."""

    def __init__(self, directory: str, compact_every: int = 1000, fsync: bool = False):
        self.directory = directory
        self.compact_every = max(1, int(compact_every))
        self.fsync = fsync
        self.snapshot_path = os.path.join(directory, "snapshot.json")
        self.wal_path = os.path.join(directory, "wal.jsonl")
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        self._fh = None
        self._seq = 0  # newest seq ever issued (snapshot or log)
        self._records_since_compact = 0
        self.compactions = 0

    # -- load ------------------------------------------------------------------

    def load(self) -> Tuple[Optional[dict], List[dict]]:
        """(snapshot state, records past it) — what a restarted server
        replays.  Also primes the seq counter and re-opens the log for
        appending.  A torn final line (crash mid-append: the record was
        never acknowledged) is truncated away — the file must end on a
        clean line boundary or the next append would concatenate onto the
        torn bytes and lose itself to the same torn-tail rule on the
        following restart.  A torn *snapshot* is impossible by construction
        (``os.replace``)."""
        with self._lock:
            snapshot = None
            last_seq = 0
            if os.path.exists(self.snapshot_path):
                with open(self.snapshot_path) as f:
                    wrapped = json.load(f)
                snapshot = wrapped["state"]
                last_seq = int(wrapped["last_seq"])
            records = []
            if os.path.exists(self.wal_path):
                with open(self.wal_path, "rb") as f:
                    data = f.read()
                valid_end = 0
                for raw in data.splitlines(keepends=True):
                    if not raw.endswith(b"\n"):
                        break  # torn tail: the crash point, nothing after it
                    line = raw.strip()
                    if line:
                        try:
                            rec = json.loads(line)
                        except (json.JSONDecodeError, UnicodeDecodeError):
                            break
                        if int(rec.get("seq", 0)) > last_seq:
                            records.append(rec)
                    valid_end += len(raw)
                if valid_end < len(data):
                    with open(self.wal_path, "rb+") as f:
                        f.truncate(valid_end)
            self._seq = max(last_seq, *(int(r["seq"]) for r in records)) if records else last_seq
            self._records_since_compact = len(records)
            self._open_locked()
            return snapshot, records

    # -- append ----------------------------------------------------------------

    def append(self, record: Dict) -> int:
        """Durably append one record; returns its assigned ``seq``."""
        with self._lock:
            if self._fh is None:
                self._open_locked()
            self._seq += 1
            record = dict(record, seq=self._seq)
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._records_since_compact += 1
            return self._seq

    def needs_compact(self) -> bool:
        with self._lock:
            return self._records_since_compact >= self.compact_every

    def cursor(self) -> int:
        """Newest seq issued so far.  Capture this *before* dumping state
        for :meth:`compact`: any record appended during the dump gets a
        higher seq and is preserved by the compaction instead of being
        covered by ``last_seq`` while absent from the snapshot."""
        with self._lock:
            return self._seq

    # -- compaction ------------------------------------------------------------

    def compact(self, state: Dict, as_of_seq: Optional[int] = None) -> None:
        """Fold the log into ``state`` — the caller's dump, which must
        include every record acknowledged up to ``as_of_seq`` (default: the
        seq at call time, only safe when no appends can race the dump).
        Atomically publish the snapshot, then rewrite the log keeping the
        records newer than ``as_of_seq``: they may be missing from the dump
        and replaying them is idempotent even when the dump caught them."""
        with self._lock:
            as_of = self._seq if as_of_seq is None else int(as_of_seq)
            tmp = f"{self.snapshot_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"last_seq": as_of, "state": state}, f, sort_keys=True)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            kept: List[str] = []
            if as_of < self._seq and os.path.exists(self.wal_path):
                with open(self.wal_path) as f:
                    for line in f:
                        line = line.strip()
                        if line and int(json.loads(line).get("seq", 0)) > as_of:
                            kept.append(line)
            if self._fh is not None:
                self._fh.close()
            wal_tmp = f"{self.wal_path}.tmp.{os.getpid()}"
            with open(wal_tmp, "w") as f:
                f.write("".join(line + "\n" for line in kept))
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(wal_tmp, self.wal_path)
            self._open_locked()
            self._records_since_compact = len(kept)
            self.compactions += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def _open_locked(self) -> None:
        self._fh = open(self.wal_path, "a")

"""Pre-copy live migration primitives (DESIGN.md §13).

VM-style migration on the content-addressed checkpoint stack: while the
world keeps computing, ranks stream *rounds* of their app state to the
chunk store — the store makes unchanged leaves free (a re-put of a
present digest is a reference), so each round ships only the bytes
dirtied since the last.  The driver converges when the dirty set stops
shrinking and only then pays a stop-the-world pause for the final delta.

This module holds the substrate-free pieces shared by the thread world
(core/runtime.py) and the process world (core/procworld.py):

  * ``split_state`` / ``join_state`` — leaf-granular decomposition of an
    app state for dirty tracking (a str-keyed dict gets one leaf per key,
    the common training-state shape; anything else is a single leaf);
  * ``stream_round`` — digest-diff against the previous round's streamed
    manifest, upload only dirty leaves;
  * round manifests — ``ROUND_<k>.json`` files in the checkpoint dir.
    Deliberately never named ``MANIFEST.json``: a SIGKILL mid-round
    leaves the last *committed* checkpoint exactly as restorable as it
    was (rounds are staging, the manifest is the commit — same
    commit-last discipline as DESIGN.md §9).
"""
from __future__ import annotations

import json
import os
import pickle
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Set, Tuple

from repro_torch.checkpoint.chunkstore import content_digest
from repro_torch.core.messages import loads_wire

ROUND_VERSION = 1

#: leaf name used when the state is not a str-keyed dict (single blob)
LEAF_SINGLETON = "_"


# ------------------------------------------------------------- leaf split

def split_state(state: Any) -> Dict[str, bytes]:
    """Decompose an app state into named leaf pickles for dirty tracking.

    A str-keyed dict yields one leaf per key, so a step that touches one
    entry dirties one chunk, not the whole image.  Any other shape is a
    single ``LEAF_SINGLETON`` leaf (still correct — just coarser: the
    whole state re-ships whenever anything changed)."""
    if (isinstance(state, dict) and state
            and all(isinstance(k, str) and k != LEAF_SINGLETON
                    for k in state)):
        return {k: pickle.dumps(state[k], pickle.HIGHEST_PROTOCOL)
                for k in sorted(state)}
    return {LEAF_SINGLETON: pickle.dumps(state, pickle.HIGHEST_PROTOCOL)}


def join_state(leaves: Dict[str, bytes]) -> Any:
    """Inverse of ``split_state``."""
    if set(leaves) == {LEAF_SINGLETON}:
        return loads_wire(leaves[LEAF_SINGLETON])
    return {k: loads_wire(b) for k, b in leaves.items()}


# ---------------------------------------------------------------- rounds

def stream_round(store, state: Any,
                 prev_digests: Dict[str, str]) -> Tuple[dict, Dict[str, str]]:
    """Ship this rank's dirty leaves: every leaf whose content digest
    differs from `prev_digests` (the chunk names streamed last round) is
    put to the store; unchanged leaves are references by construction.
    Returns ``(entry, digests)`` — the round-manifest entry and the new
    digest memo for the next diff."""
    leaves = split_state(state)
    entry_leaves: Dict[str, dict] = {}
    digests: Dict[str, str] = {}
    shipped = total = 0
    dirty = []
    for leaf, blob in leaves.items():
        name = f"{content_digest(blob)}.bin"
        digests[leaf] = name
        total += len(blob)
        entry_leaves[leaf] = {"chunk": name, "bytes": len(blob)}
        if prev_digests.get(leaf) != name:
            store.put(name, blob)
            shipped += len(blob)
            dirty.append(leaf)
        else:
            store.ref(name, len(blob))
    entry = {"leaves": entry_leaves, "shipped_bytes": shipped,
             "total_bytes": total, "dirty_leaves": sorted(dirty)}
    return entry, digests


def entries_chunks(entries: Dict[int, dict]) -> Set[str]:
    """Every chunk name a set of round entries references — the live set
    a migration pins under its gc lease."""
    out: Set[str] = set()
    for e in entries.values():
        for leaf in e.get("leaves", {}).values():
            out.add(leaf["chunk"])
    return out


# ------------------------------------------------ destination pre-staging

class StagedState:
    """Destination-side materialisation of one migrating rank's state.

    Real pre-copy migration loads memory at the DESTINATION while the
    source keeps running; the final pause then patches only the dirty
    delta.  The migration driver feeds each round's entry through
    ``absorb`` (fetch + unpickle dirty leaves — off the pause path);
    ``materialize`` then builds the replacement's live state from the
    committed manifest entry, fetching and unpickling ONLY the leaves no
    round staged — the pause cost is O(final delta), not O(state)."""

    def __init__(self, store):
        self.store = store
        self._leaves: Dict[str, Tuple[str, Any]] = {}  # leaf -> (chunk, obj)

    def absorb(self, entry: dict) -> None:
        """Stage one round's leaves (best-effort: a failed fetch just
        leaves that leaf for the final materialize)."""
        for leaf, p in entry.get("leaves", {}).items():
            cur = self._leaves.get(leaf)
            if cur is not None and cur[0] == p["chunk"]:
                continue
            try:
                blob = self.store.get(p["chunk"])
                self._leaves[leaf] = (p["chunk"], loads_wire(blob))
            except (OSError, KeyError, pickle.UnpicklingError):
                self._leaves.pop(leaf, None)

    def materialize(self, manifest_entry: dict) -> Tuple[Any, int]:
        """Final state from a committed leaf-split manifest entry; returns
        ``(state, fetched_bytes)`` where fetched_bytes covers exactly the
        leaves pre-copy rounds did not stage."""
        parts = {k[len("app/"):]: p
                 for k, p in manifest_entry["parts"].items()
                 if k.startswith("app/")}
        state: Dict[str, Any] = {}
        fetched = 0
        for leaf, p in sorted(parts.items()):
            cur = self._leaves.get(leaf)
            if cur is not None and cur[0] == p["chunk"]:
                state[leaf] = cur[1]
            else:
                blob = self.store.get(p["chunk"])
                fetched += len(blob)
                state[leaf] = loads_wire(blob)
        if set(state) == {LEAF_SINGLETON}:
            return state[LEAF_SINGLETON], fetched
        return state, fetched


# ------------------------------------------------------- round manifests

def round_path(ckpt_dir: str | Path, round_no: int) -> Path:
    return Path(ckpt_dir) / f"ROUND_{round_no:04d}.json"


def write_round_manifest(ckpt_dir: str | Path, round_no: int,
                         entries: Dict[int, dict], generation: int,
                         store_spec: Optional[str] = None,
                         chunk_dir: Optional[str] = None) -> Path:
    """Persist one pre-copy round (tmp + atomic rename, like every other
    commit in this stack).  Restart-side value: a replacement host that
    dies before the final manifest can still warm its cache from the
    newest round file — and the previous committed checkpoint is
    untouched either way."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    man = {"version": ROUND_VERSION, "round": round_no,
           "generation": generation,
           "ranks": {str(r): e for r, e in sorted(entries.items())}}
    if store_spec is not None:
        man["store"] = str(store_spec)
    if chunk_dir is not None:
        man["chunk_dir"] = chunk_dir
    path = round_path(ckpt_dir, round_no)
    tmp = path.with_name(
        path.name + f".tmp{os.getpid()}-{threading.get_ident()}")
    tmp.write_text(json.dumps(man, indent=1, sort_keys=True))
    os.replace(tmp, path)
    return path


def load_round_manifest(ckpt_dir: str | Path, round_no: int) -> dict:
    man = json.loads(round_path(ckpt_dir, round_no).read_text())
    if man.get("version", 0) > ROUND_VERSION:
        raise ValueError(f"round manifest v{man['version']} too new")
    return man


def latest_round(ckpt_dir: str | Path) -> Optional[int]:
    """Highest round number with a committed round manifest, or None."""
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    rounds = []
    for p in d.glob("ROUND_*.json"):
        try:
            rounds.append(int(p.stem.split("_", 1)[1]))
        except ValueError:
            continue
    return max(rounds) if rounds else None

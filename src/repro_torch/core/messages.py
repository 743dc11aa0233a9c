"""Wire-level message envelope + MPI datatype table.

The Envelope is the ONLY thing that crosses the transport; payloads are
opaque bytes to the proxy (the proxy never interprets application data —
part of the paper's agnosticism argument).

Checkpointed envelopes and v2 rank images are pickles, and a pickle names
its classes.  So that a rank image restarts under either package, both
write the reference's names: ``dumps_wire`` writes
``repro.core.messages.Envelope`` (and ``repro.core.ckpt_protocol.RankImage``)
for the port's classes, byte for byte what the reference's ``pickle.dumps``
writes for the same fields, without importing the reference; and
``loads_wire`` maps those names back to the port's classes and refuses any
other ``repro.*`` name instead of importing it.
"""
from __future__ import annotations

import importlib
import io
import pickle
from dataclasses import dataclass
from typing import Any

import numpy as np

ANY_SOURCE = -1
ANY_TAG = -1

# reserved tag space for collectives (user tags must be < COLL_TAG_BASE)
COLL_TAG_BASE = 1 << 24

# MPI basic datatypes -> byte size (paper API: MPI_Type_size)
DATATYPES = {
    "MPI_BYTE": 1, "MPI_CHAR": 1, "MPI_INT": 4, "MPI_LONG": 8,
    "MPI_FLOAT": 4, "MPI_DOUBLE": 8, "MPI_INT32_T": 4, "MPI_INT64_T": 8,
    "MPI_UINT8_T": 1, "MPI_UINT32_T": 4, "MPI_UINT64_T": 8,
}

_NP_TO_MPI = {
    np.dtype(np.uint8): "MPI_BYTE", np.dtype(np.int32): "MPI_INT",
    np.dtype(np.int64): "MPI_LONG", np.dtype(np.float32): "MPI_FLOAT",
    np.dtype(np.float64): "MPI_DOUBLE",
}


@dataclass(frozen=True)
class Envelope:
    src: int                 # world ranks
    dst: int
    tag: int
    comm_vid: int
    seq: int                 # per (src,dst) monotonically increasing
    payload: Any             # bytes (pickled value) or a known-dtype ndarray
    dtype: str = "MPI_BYTE"
    count: int = 0

    def to_bytes(self) -> bytes:
        return dumps_wire(self)

    @staticmethod
    def from_bytes(b: bytes) -> "Envelope":
        return loads_wire(b)


# -- wire names -------------------------------------------------------------
#: the reference's (module, qualname) of each class a checkpoint pickles,
#: and the port's module that holds the same class
WIRE_CLASSES = {
    ("repro.core.messages", "Envelope"): "repro_torch.core.messages",
    ("repro.core.ckpt_protocol", "RankImage"):
        "repro_torch.core.ckpt_protocol",
}
_PORT_TO_WIRE = {(port, name): ref
                 for (ref, name), port in WIRE_CLASSES.items()}


class WireNameError(pickle.UnpicklingError):
    """A pickle names a class of the reference package that the port does
    not map to its own."""


class _WirePickler(pickle._Pickler):
    """The stdlib's Python pickler (its output is the C pickler's, byte for
    byte), writing the reference's name for each class of ``WIRE_CLASSES``.
    The stdlib's ``save_global`` imports the module it names to check it,
    so the mapped classes are written here instead."""

    def save_global(self, obj, name=None):
        ref = _PORT_TO_WIRE.get((getattr(obj, "__module__", None),
                                 getattr(obj, "__qualname__", None)))
        if ref is None or name is not None:
            return super().save_global(obj, name)
        assert self.proto >= 4, self.proto
        self.save(ref)
        self.save(obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _WireUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "repro" or module.startswith("repro."):
            port = WIRE_CLASSES.get((module, name))
            if port is None:
                raise WireNameError(
                    f"refusing to load {module}.{name}: the port maps only "
                    f"{sorted('.'.join(k) for k in WIRE_CLASSES)} of the "
                    f"reference package")
            return getattr(importlib.import_module(port), name)
        return super().find_class(module, name)


def dumps_wire(obj: Any) -> bytes:
    """``pickle.dumps(obj, protocol=HIGHEST_PROTOCOL)`` with the reference's
    names for the port's checkpointed classes."""
    buf = io.BytesIO()
    _WirePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads_wire(b) -> Any:
    """``pickle.loads`` for everything a rank checkpoint holds: the
    reference's names of ``WIRE_CLASSES`` load as the port's classes, and
    any other ``repro.*`` name raises ``WireNameError``."""
    return _WireUnpickler(io.BytesIO(b)).load()


def pack(obj: Any) -> tuple[Any, str, int]:
    """Application value -> (payload, mpi_dtype, count).

    Known-dtype ndarrays stay ARRAYS (a private contiguous copy — senders
    may mutate their buffer right after a nonblocking send): on socket
    paths they ride scatter-gather frames as pickle protocol-5 out-of-band
    buffers instead of being pre-pickled into bytes, and the shm-ring
    fabric parks them in shared memory behind a descriptor.  Everything
    else pickles to opaque bytes exactly as before — the proxy still never
    interprets application data."""
    if isinstance(obj, np.ndarray):
        dt = _NP_TO_MPI.get(obj.dtype)
        if dt is not None:
            return np.ascontiguousarray(obj).copy(), dt, obj.size
    raw = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return raw, "MPI_BYTE", len(raw)


def unpack(env: Envelope) -> Any:
    """Payload -> application value.  Array payloads come back writable —
    copies only when the delivered view is readonly (e.g. decoded from an
    immutable bytes body)."""
    p = env.payload
    if isinstance(p, np.ndarray):
        return p if p.flags.writeable else p.copy()
    return pickle.loads(p)


def payload_nbytes(p: Any) -> int:
    """Byte size of a payload, array or bytes (``len()`` on an ndarray
    would count first-axis elements, not bytes)."""
    return int(p.nbytes) if isinstance(p, np.ndarray) else len(p)


@dataclass
class Status:
    """MPI_Status analogue (virtualized — no backend structure leaks)."""
    source: int = ANY_SOURCE
    tag: int = ANY_TAG
    count: int = 0
    dtype: str = "MPI_BYTE"

    def get_count(self, datatype: str) -> int:
        """MPI_Get_count semantics."""
        size = DATATYPES[datatype]
        if self.dtype == "MPI_BYTE" and datatype != "MPI_BYTE":
            return self.count // size
        if datatype == self.dtype:
            return self.count
        total = self.count * DATATYPES[self.dtype]
        return total // size

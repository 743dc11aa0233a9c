"""The paper's primary contribution, the port's copy: implementation-agnostic
MPI checkpoint/restart via proxies (DMTCP plugin model), adapted per
DESIGN.md.  The package imports no ``torch``: rank applications are numpy.

Public surface:
    MPI            — passive stub (plugin): full API incl. collectives
    MPIJob         — runtime: launch, async checkpoint, restart
    Coordinator    — DMTCP-style coordinator (drain counters, ckpt FSM)
    transports     — "shm" / "tcp" / "inproc" (three 'MPI implementations')
                     plus "proc": every rank a REAL OS process behind a
                     socket proxy endpoint (core/procworld.py, DESIGN §10),
                     and "shmring": the same with tensors crossing through
                     a shared-memory ring (core/dataplane.py)

Beside it live the process-wide metrics group, span recorder and socket
framing that the checkpoint manager and the chunk service use.
"""
import importlib

# name -> module; loaded on first use, so the checkpoint manager's and the
# chunk service's imports of trace and metrics do not load the rank runtime
_EXPORTS = {
    "MPI": "api", "COMM_WORLD": "api",
    "Coordinator": "coordinator",
    "ANY_SOURCE": "messages", "ANY_TAG": "messages", "Status": "messages",
    "MPIJob": "runtime",
    "TRANSPORTS": "transport", "available_transports": "transport",
    "make_transport": "transport",
}

__all__ = ["MPI", "MPIJob", "Coordinator", "COMM_WORLD", "ANY_SOURCE",
           "ANY_TAG", "Status", "TRANSPORTS", "available_transports",
           "make_transport"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value

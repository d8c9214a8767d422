"""Per-step collective traffic (counterpart of ``utils/hlo.py`` of the JAX
package).

The JAX package counts the collectives of a compiled step in its HLO text.
The port has no HLO: every collective of ``parallel/`` and of the synced
BatchNorm goes through ``parallel/collectives.py``, which records it as it
is issued. Reset the record, run a step, read it:

    reset_collective_traffic()
    step(model, optimizer, batch)
    traffic = collective_traffic()

``bytes`` are result bytes, what each participant receives, as in the JAX
package; multiply by the ring's factor (2(d-1)/d for an all-reduce) for the
bytes on the wire. A gather is issued as an all-reduce of a slot buffer
(``parallel.collectives.gather_slots``), and counted as that.
"""

from __future__ import annotations

from pointnet_like_pose_estimation_tpu_torch.parallel import collectives as _c


def collective_traffic() -> dict:
    """``{"total_bytes", "by_op": {op: {"count", "bytes"}}, "by_site": {site:
    {op: {"count", "bytes"}}}}`` of every collective since the last reset,
    under JAX's op names (``all-reduce``; ``broadcast``, which XLA's HLO
    has no name for)."""
    by_op: dict[str, dict[str, int]] = {}
    for ops in _c.TRAFFIC.values():
        for op, rec in ops.items():
            total = by_op.setdefault(op, {"count": 0, "bytes": 0})
            total["count"] += rec["count"]
            total["bytes"] += rec["bytes"]
    return {
        "total_bytes": sum(r["bytes"] for r in by_op.values()),
        "by_op": by_op,
        "by_site": {site: {op: dict(rec) for op, rec in ops.items()} for site, ops in _c.TRAFFIC.items()},
    }


def reset_collective_traffic() -> None:
    _c.reset_traffic()

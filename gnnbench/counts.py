"""Counts of work taken from the raw samples, never from the program's arrays."""

from __future__ import annotations

from typing import List


def edges(raws: List[dict], adj: str) -> int:
    """Real edges of adjacency `adj` over a batch's raw samples."""
    return int(sum(len(r["adjacencies"][adj][0]) for r in raws))


def nodes(raws: List[dict], entity: str) -> int:
    return int(sum(r["num_nodes"][entity] for r in raws))


def edge_messages(raws: List[dict], description: dict) -> int:
    """A training step's edge-messages: over the iterations and every message
    passing of every stage, the real edges its sources read."""
    mp = description["message_passing"]
    per_iteration = sum(
        edges(raws, src["adj_vector"])
        for stage in mp["stages"]
        for p in stage["stage_mp"]
        for src in p["source_entities"]
    )
    return int(mp["num_iterations"]) * per_iteration

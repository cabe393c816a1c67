"""Prefill/decode disaggregation helpers.

Port of ``repro.serve.cluster.disagg``.  The mechanism lives in the two
layers below: the cache migrates blocks (:meth:`PagedKVCache.export_blocks` /
:meth:`import_blocks`; wire width = storage width: fp32 pools as fp32, a bf16
pool as its bits in uint16, int8 codes as int8, packed int4 as uint8 nibble
pairs, scales as fp32) and the engine runs the two halves
(:meth:`PagedServeEngine.prefill_handoff` / :meth:`submit_handoff`).  This
module supplies the topology plumbing: the ``P:D`` split of a replica fleet,
and a direct engine-to-engine handoff for tests and parity gates without
mailboxes."""

from __future__ import annotations

import copy
import dataclasses

from repro_torch.serve.cluster.replica import ReplicaConfig

__all__ = ["parse_disagg", "make_cluster_configs", "handoff_local"]


def parse_disagg(spec: str) -> tuple[int, int]:
    """``"P:D"`` -> (prefill replicas, decode replicas), both >= 1."""
    try:
        p, d = (int(x) for x in spec.split(":"))
    except ValueError:
        raise ValueError(f"--disagg wants P:D (e.g. 1:2), got {spec!r}") from None
    if p < 1 or d < 1:
        raise ValueError(f"--disagg needs at least one replica per role, got {spec!r}")
    return p, d


def make_cluster_configs(base: ReplicaConfig, replicas: int = 0,
                         disagg: tuple[int, int] | None = None) -> list[ReplicaConfig]:
    """Fan a base config out into a named fleet: ``replicas`` homogeneous
    ``both``-role engines, or a ``(P, D)`` disaggregated split (``p0..``
    prefill-only, ``d0..`` decode-only)."""
    if disagg is not None:
        p, d = disagg
        return (
            [dataclasses.replace(base, name=f"p{i}", role="prefill") for i in range(p)]
            + [dataclasses.replace(base, name=f"d{i}", role="decode") for i in range(d)]
        )
    if replicas < 1:
        raise ValueError("need --replicas >= 1 or a --disagg split")
    return [dataclasses.replace(base, name=f"r{i}", role="both") for i in range(replicas)]


def handoff_local(prefill_engine, decode_engine, req) -> dict:
    """Engine-to-engine migration without a cluster: run the prompt on
    ``prefill_engine``, hand the exported blocks to ``decode_engine``'s
    queue.  Returns the wire payload (for size and dtype checks).  The caller
    steps ``decode_engine`` to completion."""
    from repro_torch.serve.engine import Request

    probe = Request(uid=req.uid, prompt=copy.deepcopy(req.prompt),
                    max_new=req.max_new, eos_id=req.eos_id)
    payload = prefill_engine.prefill_handoff(probe)
    decode_engine.submit_handoff(req, payload)
    return payload

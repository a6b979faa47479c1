"""Replicated serving fleet (roc_tpu/fleet): WAL-shipped delta replication
behind a backpressure-aware router.

The delta write-ahead journal (serve/delta.py) is a replication log, and
this package ships it.  One primary ServeEngine owns the delta write path;
its journal tail is sealed into CRC-framed segments (:mod:`.replog`, byte
for byte roc_tpu's, so a segment sealed by either package replays in the
other) and published over a transport (in-process deque, spool directory,
or localhost TCP) to follower replicas (:mod:`.replica`) that replay the
records through the classify and row-patch path the primary ran:
deterministic classification keeps every member in bitwise seq-lockstep.
Queries are dispatched by a least-loaded, freshness-floored router
(:mod:`.router`) that turns per-replica overload into typed fleet-wide
backpressure and drives an autoscale hook off the watchdog's EWMAs.

``python -m roc_tpu_torch.fleet --selftest [--device cuda|cpu]`` is the
drill: 3 replicas, a mixed query and delta stream, one seeded replica
kill, parity and catch-up checked.
"""

from roc_tpu_torch.fleet.replica import Replica
from roc_tpu_torch.fleet.replog import (FileTransport, InProcTransport,
                                        ReplicationError, ReplicationLog,
                                        SegmentGapError, SegmentRotError,
                                        SocketTransport, TornSegmentError,
                                        Transport, decode_segment,
                                        encode_segment,
                                        install_snapshot_files,
                                        replay_segment)
from roc_tpu_torch.fleet.router import FleetOverloaded, FleetRouter

__all__ = [
    "Replica", "ReplicationLog", "Transport", "InProcTransport",
    "FileTransport", "SocketTransport", "encode_segment",
    "decode_segment", "replay_segment", "install_snapshot_files",
    "ReplicationError", "TornSegmentError", "SegmentGapError",
    "SegmentRotError", "FleetRouter", "FleetOverloaded",
]

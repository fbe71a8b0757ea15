"""The wire transport (port of ``repro.net``): parameter-server processes
serving sampler processes over TCP.

* :mod:`repro_torch.net.protocol`: the framed binary protocol, byte for
  byte the reference's, so either package's peer talks to the other's.
* :mod:`repro_torch.net.server`: :class:`ShardServer` and
  :func:`serve_shards`, vocabulary row-range shards of the canonical
  statistics on the card, applying pushes at deterministic round barriers
  (bit-exact with the in-process BSP path) and answering SSP pulls with
  ``NOT_MODIFIED`` within the staleness bound.
* :mod:`repro_torch.net.client`: :class:`RemoteParameterServer`, the
  client half behind ``TrainerConfig(transport="tcp")``.
* :mod:`repro_torch.net.chaos`: :class:`ChaosProxy`, a seeded frame-aware
  relay that drops, delays and truncates frames per a
  :class:`~repro_torch.core.fault.FaultPlan`'s network events.

The multi-process launcher is :mod:`repro_torch.launch.loopback`.
"""

from repro_torch.net.chaos import ChaosProxy, interpose
from repro_torch.net.client import RemoteError, RemoteParameterServer
from repro_torch.net.protocol import (PROTOCOL_VERSION, ConnectionClosed,
                                      IdleTimeout, MsgType, ProtocolError,
                                      TransportError)
from repro_torch.net.server import ShardServer, serve_shards

__all__ = [
    "ChaosProxy",
    "ConnectionClosed",
    "IdleTimeout",
    "MsgType",
    "PROTOCOL_VERSION",
    "ProtocolError",
    "RemoteError",
    "RemoteParameterServer",
    "ShardServer",
    "TransportError",
    "interpose",
    "serve_shards",
]

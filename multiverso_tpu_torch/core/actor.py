"""Wire message header + payload: ``Message`` and ``MsgType``.

Port of the part of ``multiverso_tpu/core/actor.py`` that the serving
plane's framing carries (``parallel/net.py``). The actor runtime itself
(mailbox threads over the native MtQueue) serves the PS request path and
waits with it (ROADMAP A7).
"""

from __future__ import annotations

import enum
from typing import Any, List, Optional


class MsgType(enum.IntEnum):
    """Wire types (ref message.h:13-24). Sign encodes request/reply; range
    encodes the destination actor class (communicator.cpp:15-27)."""
    Request_Get = 1
    Request_Add = 2
    Reply_Get = -1
    Reply_Add = -2
    Server_Finish_Train = 31
    Control_Barrier = 33
    Control_Register = 34
    Control_Lookup = 35
    # Elastic membership announce (MXNET-MPI, PAPERS.md 1801.03855): a
    # worker joins/leaves a table's LIVE server-side clock group. Payload
    # is the net.py JSON control codec.
    Control_Elastic = 36
    Reply_Register = -34
    Reply_Lookup = -35
    Reply_Elastic = -36
    # Serving plane (multiverso_tpu/serving): request-level inference reads
    # over the same framing. In the server range so to_server routing holds.
    Serve_Request = 21
    Serve_Reply = -21
    Serve_Cancel = 22   # hedged-loser cancel: drop the request at admission
    # (msg_id names the original request; best-effort, no reply of its own
    # — a cancelled request answers its ORIGINAL msg_id with Reply_Error)
    Heartbeat = 40
    Heartbeat_Reply = -40
    # Fleet control plane (multiverso_tpu/fleet): replica-group membership
    # + routing-table exchange over the same framing. Payloads are the
    # net.py JSON control codec (low-rate control traffic, not data path).
    Fleet_Join = 42
    Reply_Fleet_Join = -42
    Fleet_Heartbeat = 43
    Reply_Fleet_Heartbeat = -43
    Fleet_Route = 44
    Reply_Fleet_Route = -44
    Fleet_Leave = 45
    Reply_Fleet_Leave = -45
    Fleet_Drain = 46        # operator-initiated rolling drain trigger
    Reply_Fleet_Drain = -46
    Fleet_Stats = 47        # cluster-wide metric rollup pull (fleet_top)
    Reply_Fleet_Stats = -47
    Reply_Error = -99   # server-side rejection (e.g. unknown table); wakes
    Exit = 99           # the waiter loudly instead of hanging a BSP wait


class Message:
    """Header + payload (ref message.h:26-68)."""

    __slots__ = ("src", "dst", "type", "table_id", "msg_id", "data")

    def __init__(self, src: int = -1, dst: int = -1,
                 type: int = MsgType.Request_Get, table_id: int = -1,
                 msg_id: int = -1, data: Optional[List[Any]] = None):
        self.src = src
        self.dst = dst
        self.type = int(type)
        self.table_id = table_id
        self.msg_id = msg_id
        self.data = data if data is not None else []

    def create_reply(self) -> "Message":
        """Reply inverts src/dst and negates the type (ref message.h:51-59)."""
        return Message(src=self.dst, dst=self.src, type=-self.type,
                       table_id=self.table_id, msg_id=self.msg_id)

    # destination routing (ref communicator.cpp:15-27)
    def to_server(self) -> bool:
        return 0 < self.type < 32

    def to_worker(self) -> bool:
        return -32 < self.type < 0

    def to_controller(self) -> bool:
        return self.type > 32

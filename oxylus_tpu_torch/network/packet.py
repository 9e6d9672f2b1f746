"""Network packet model: Handshake / SceneSnapshot / ClientAck / RPC (a copy of
`oxylus_tpu/network/packet.py`; the same bytes on the wire).

Mirrors the reference's packet kinds and RPC-by-name-hash design
(`Oxylus/include/Networking/NetPacket.hpp:20-100`): RPCs address a
function by a stable 64-bit FNV-1a hash of its name and carry variant parameters;
snapshot packets carry `SnapshotDelta` payloads from `oxylus_tpu_torch.scene.snapshot`.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Any

from ..scene.snapshot import SnapshotDelta
from .wire import pack_value, unpack_value

MAGIC = 0x4F58  # "OX"
PROTOCOL_VERSION = 1


class PacketKind(enum.IntEnum):
    HANDSHAKE = 0
    SCENE_SNAPSHOT = 1
    CLIENT_ACK = 2
    RPC = 3
    DISCONNECT = 4


def fnv1a64(name: str) -> int:
    """Stable RPC name hash (the reference hashes RPC names the same way)."""
    h = 0xCBF29CE484222325
    for b in name.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class Handshake:
    client_name: str = ""
    protocol_version: int = PROTOCOL_VERSION

    kind = PacketKind.HANDSHAKE

    def payload(self) -> Any:
        return {"name": self.client_name, "version": self.protocol_version}

    @classmethod
    def from_payload(cls, p) -> "Handshake":
        return cls(client_name=p["name"], protocol_version=p["version"])


@dataclasses.dataclass
class SceneSnapshotPacket:
    delta: SnapshotDelta

    kind = PacketKind.SCENE_SNAPSHOT

    def payload(self) -> Any:
        return {
            "seq": self.delta.sequence,
            "base": self.delta.base_sequence,
            "created": {
                str(i): {"name": e["name"], "tags": list(e["tags"]), "components": e["components"]}
                for i, e in self.delta.created.items()
            },
            "removed": list(self.delta.removed),
            "changed": {str(i): c for i, c in self.delta.changed.items()},
        }

    @classmethod
    def from_payload(cls, p) -> "SceneSnapshotPacket":
        return cls(
            SnapshotDelta(
                sequence=p["seq"],
                base_sequence=p["base"],
                created={
                    int(i): {
                        "name": e["name"],
                        "tags": tuple(e["tags"]),
                        "components": e["components"],
                    }
                    for i, e in p["created"].items()
                },
                removed=tuple(p["removed"]),
                changed={int(i): c for i, c in p["changed"].items()},
            )
        )


@dataclasses.dataclass
class ClientAck:
    sequence: int

    kind = PacketKind.CLIENT_ACK

    def payload(self) -> Any:
        return self.sequence

    @classmethod
    def from_payload(cls, p) -> "ClientAck":
        return cls(sequence=p)


@dataclasses.dataclass
class RPC:
    name_hash: int
    params: list[Any]
    rpc_id: int = 0  # for reliable delivery acks

    kind = PacketKind.RPC

    @classmethod
    def call(cls, name: str, *params: Any, rpc_id: int = 0) -> "RPC":
        return cls(name_hash=fnv1a64(name), params=list(params), rpc_id=rpc_id)

    def payload(self) -> Any:
        return {"h": self.name_hash, "p": self.params, "id": self.rpc_id}

    @classmethod
    def from_payload(cls, p) -> "RPC":
        return cls(name_hash=p["h"], params=p["p"], rpc_id=p["id"])


@dataclasses.dataclass
class Disconnect:
    reason: str = ""

    kind = PacketKind.DISCONNECT

    def payload(self) -> Any:
        return self.reason

    @classmethod
    def from_payload(cls, p) -> "Disconnect":
        return cls(reason=p)


_PACKET_TYPES = {
    PacketKind.HANDSHAKE: Handshake,
    PacketKind.SCENE_SNAPSHOT: SceneSnapshotPacket,
    PacketKind.CLIENT_ACK: ClientAck,
    PacketKind.RPC: RPC,
    PacketKind.DISCONNECT: Disconnect,
}

_HEADER = struct.Struct("<HBB")  # magic, kind, version


def encode_packet(packet) -> bytes:
    body = pack_value(packet.payload())
    return _HEADER.pack(MAGIC, int(packet.kind), PROTOCOL_VERSION) + body


def decode_packet(data: bytes):
    if len(data) < _HEADER.size:
        raise ValueError("short packet")
    magic, kind, version = _HEADER.unpack_from(data)
    if magic != MAGIC:
        raise ValueError("bad magic")
    if version != PROTOCOL_VERSION:
        raise ValueError(f"protocol version mismatch {version}")
    cls = _PACKET_TYPES[PacketKind(kind)]
    return cls.from_payload(unpack_value(data[_HEADER.size :]))

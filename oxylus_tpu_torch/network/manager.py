"""NetworkManager / NetServer / NetClient over non-blocking UDP (a copy of
`oxylus_tpu/network/manager.py`; a port host talks to a JAX host).

The enet replacement (`Oxylus/include/Networking/NetworkManager.hpp:24-71`,
`NetClient.hpp:37-69`): a `NetworkManager` module owning subclassable server/client
hosts; per-peer snapshot replication with ack-driven deltas (`SceneSnapshotBuilder`);
RPC with at-least-once reliability (retry until acked via rpc_id); peer connect/
disconnect events. `service()` must be pumped every frame (the enet_host_service model —
the reference calls it from `NetworkManager::update`).
"""

from __future__ import annotations

import dataclasses
import logging
import socket
import time
from typing import Any, Callable

from ..scene.snapshot import SceneSnapshotBuilder
from .packet import (
    RPC,
    ClientAck,
    Disconnect,
    Handshake,
    PacketKind,
    SceneSnapshotPacket,
    decode_packet,
    encode_packet,
    fnv1a64,
)

log = logging.getLogger("oxylus.net")

MAX_DATAGRAM = 60000


@dataclasses.dataclass
class Peer:
    addr: tuple[str, int]
    name: str = ""
    connected_at: float = 0.0
    snapshots: SceneSnapshotBuilder = dataclasses.field(default_factory=SceneSnapshotBuilder)
    entity_map: dict[int, int] = dataclasses.field(default_factory=dict)
    # reliable RPC bookkeeping
    next_rpc_id: int = 1
    pending_rpcs: dict[int, tuple[bytes, float]] = dataclasses.field(default_factory=dict)
    seen_rpc_ids: set[int] = dataclasses.field(default_factory=set)

    # traffic stats (NetStatsViewer surface)
    bytes_sent: int = 0
    bytes_received: int = 0
    packets_sent: int = 0
    packets_received: int = 0


class _Host:
    """Shared UDP host machinery for server and client."""

    RPC_RESEND_INTERVAL = 0.25

    def __init__(self) -> None:
        self.sock: socket.socket | None = None
        self.rpc_handlers: dict[int, Callable] = {}

    def register_rpc(self, name: str, fn: Callable) -> None:
        self.rpc_handlers[fnv1a64(name)] = fn

    def _send_raw(self, peer: Peer, data: bytes) -> None:
        assert self.sock is not None
        self.sock.sendto(data, peer.addr)
        peer.bytes_sent += len(data)
        peer.packets_sent += 1

    def send_packet(self, peer: Peer, packet) -> None:
        self._send_raw(peer, encode_packet(packet))

    def send_rpc(self, peer: Peer, name: str, *params: Any, reliable: bool = True) -> int:
        rid = peer.next_rpc_id if reliable else 0
        if reliable:
            peer.next_rpc_id += 1
        pkt = RPC.call(name, *params, rpc_id=rid)
        data = encode_packet(pkt)
        self._send_raw(peer, data)
        if reliable:
            peer.pending_rpcs[rid] = (data, time.monotonic())
        return rid

    def _handle_rpc(self, peer: Peer, rpc: RPC) -> None:
        if rpc.rpc_id:
            # ack via lightweight rpc-ack RPC (id 0 → unreliable)
            ack = RPC(name_hash=fnv1a64("__rpc_ack"), params=[rpc.rpc_id], rpc_id=0)
            self._send_raw(peer, encode_packet(ack))
            if rpc.rpc_id in peer.seen_rpc_ids:
                return  # duplicate delivery
            peer.seen_rpc_ids.add(rpc.rpc_id)
        if rpc.name_hash == fnv1a64("__rpc_ack"):
            peer.pending_rpcs.pop(rpc.params[0], None)
            return
        handler = self.rpc_handlers.get(rpc.name_hash)
        if handler is None:
            log.warning("no RPC handler for hash %x", rpc.name_hash)
            return
        handler(peer, *rpc.params)

    def _resend_pending(self, peer: Peer) -> None:
        now = time.monotonic()
        for rid, (data, sent_at) in list(peer.pending_rpcs.items()):
            if now - sent_at > self.RPC_RESEND_INTERVAL:
                self._send_raw(peer, data)
                peer.pending_rpcs[rid] = (data, now)

    def _drain(self):
        assert self.sock is not None
        out = []
        while True:
            try:
                data, addr = self.sock.recvfrom(MAX_DATAGRAM)
            except BlockingIOError:
                break
            except OSError:
                break
            out.append((data, addr))
        return out


class NetServer(_Host):
    """Subclassable server host (reference `NetServer`). Override the `on_*` hooks."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        super().__init__()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self.peers: dict[tuple[str, int], Peer] = {}

    # hooks
    def on_peer_connected(self, peer: Peer) -> None: ...
    def on_peer_disconnected(self, peer: Peer) -> None: ...

    def service(self) -> None:
        for data, addr in self._drain():
            try:
                pkt = decode_packet(data)
            except ValueError as exc:
                log.warning("bad packet from %s: %s", addr, exc)
                continue
            peer = self.peers.get(addr)
            if peer is None:
                if pkt.kind != PacketKind.HANDSHAKE:
                    continue
                peer = Peer(addr=addr, name=pkt.client_name, connected_at=time.monotonic())
                self.peers[addr] = peer
                self.send_packet(peer, Handshake(client_name="server"))
                self.on_peer_connected(peer)
                continue
            peer.bytes_received += len(data)
            peer.packets_received += 1
            if pkt.kind == PacketKind.CLIENT_ACK:
                peer.snapshots.ack(pkt.sequence)
            elif pkt.kind == PacketKind.RPC:
                self._handle_rpc(peer, pkt)
            elif pkt.kind == PacketKind.DISCONNECT:
                self.peers.pop(addr, None)
                self.on_peer_disconnected(peer)
        for peer in self.peers.values():
            self._resend_pending(peer)

    def replicate(self, scene) -> None:
        """Send per-peer snapshot deltas (delta vs each peer's last ack). The
        snapshot reads the scene's host mirror: a runner on the card calls
        `SceneRunner.sync_to_host()` first, or the peers see the state as built."""
        for peer in self.peers.values():
            snap = peer.snapshots.take_snapshot(scene)
            delta = peer.snapshots.delta(snap)
            self.send_packet(peer, SceneSnapshotPacket(delta))

    def broadcast_rpc(self, name: str, *params: Any, reliable: bool = True) -> None:
        for peer in self.peers.values():
            self.send_rpc(peer, name, *params, reliable=reliable)

    def close(self) -> None:
        for peer in list(self.peers.values()):
            self.send_packet(peer, Disconnect("server shutdown"))
        self.sock.close()


class NetClient(_Host):
    """Subclassable client host (reference `NetClient`). Override `on_scene_snapshot`
    etc. Replicated state lands in `self.replica_scene` when one is attached."""

    def __init__(self, host: str, port: int, name: str = "client"):
        super().__init__()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        self.server = Peer(addr=(host, port), name="server")
        self.name = name
        self.connected = False
        self.replica_scene = None
        self.send_packet(self.server, Handshake(client_name=name))

    # hooks
    def on_connected(self) -> None: ...
    def on_disconnected(self, reason: str) -> None: ...
    def on_scene_snapshot(self, packet: SceneSnapshotPacket) -> None: ...

    def service(self) -> None:
        for data, addr in self._drain():
            try:
                pkt = decode_packet(data)
            except ValueError as exc:
                log.warning("bad packet: %s", exc)
                continue
            self.server.bytes_received += len(data)
            self.server.packets_received += 1
            if pkt.kind == PacketKind.HANDSHAKE:
                self.connected = True
                self.on_connected()
            elif pkt.kind == PacketKind.SCENE_SNAPSHOT:
                if self.replica_scene is not None:
                    from ..scene.snapshot import apply_delta

                    self.server.entity_map = apply_delta(
                        self.replica_scene, pkt.delta, self.server.entity_map
                    )
                self.send_packet(self.server, ClientAck(pkt.delta.sequence))
                self.on_scene_snapshot(pkt)
            elif pkt.kind == PacketKind.RPC:
                self._handle_rpc(self.server, pkt)
            elif pkt.kind == PacketKind.DISCONNECT:
                self.connected = False
                self.on_disconnected(pkt.reason)
        self._resend_pending(self.server)

    def rpc(self, name: str, *params: Any, reliable: bool = True) -> int:
        return self.send_rpc(self.server, name, *params, reliable=reliable)

    def close(self) -> None:
        self.send_packet(self.server, Disconnect("client quit"))
        self.sock.close()


class NetworkManager:
    """Module owning hosts (reference `NetworkManager`): create/destroy servers and
    clients; `update` pumps every host each frame."""

    MODULE_NAME = "NetworkManager"

    def __init__(self) -> None:
        self.servers: list[NetServer] = []
        self.clients: list[NetClient] = []

    def init(self, app=None) -> None: ...

    def create_server(self, port: int = 0, host: str = "127.0.0.1", cls=NetServer) -> NetServer:
        server = cls(port=port, host=host)
        self.servers.append(server)
        return server

    def create_client(self, host: str, port: int, name: str = "client", cls=NetClient) -> NetClient:
        client = cls(host, port, name=name)
        self.clients.append(client)
        return client

    def destroy_server(self, server: NetServer) -> None:
        server.close()
        self.servers.remove(server)

    def destroy_client(self, client: NetClient) -> None:
        client.close()
        self.clients.remove(client)

    def update(self, app=None, ts=None) -> None:
        for s in self.servers:
            s.service()
        for c in self.clients:
            c.service()

    def deinit(self, app=None) -> None:
        for s in list(self.servers):
            self.destroy_server(s)
        for c in list(self.clients):
            self.destroy_client(c)

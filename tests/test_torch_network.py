"""The port's network layer against the JAX package's: the same bytes for every wire
type and packet kind, snapshot replication over loopback UDP from a JAX server to a
port client and from a port server to a JAX client, reliable RPC deduplication and
disconnect events. Every socket loop runs until its condition or a 2 s deadline."""

import time

import numpy as np
import pytest
import torch

from oxylus_tpu.network import manager as jman
from oxylus_tpu.network import packet as jpkt
from oxylus_tpu.network import wire as jwire
from oxylus_tpu.scene import scene as jscene
from oxylus_tpu.scene import snapshot as jsnap
from oxylus_tpu.scene import state as jstate
from oxylus_tpu_torch.network import manager as tman
from oxylus_tpu_torch.network import packet as tpkt
from oxylus_tpu_torch.network import wire as twire
from oxylus_tpu_torch.scene import scene as tscene
from oxylus_tpu_torch.scene import snapshot as tsnap
from oxylus_tpu_torch.scene import state as tstate

torch.set_num_threads(1)

DEADLINE = 2.0

VALUES = [
    None, True, False, 0, -5, 2**40, -(2**63), 2**63 - 1, 2**63, 2**64 - 1, 3.25, -0.0, float("inf"),
    "", "héllo", b"", b"\x00\xff", bytearray(b"ab"), memoryview(b"cd"), [], (1, "x"), {},
    {"a": [1, 2.5, "x", None], "b": {"nested": [True]}, 7: "int key"},
    np.arange(12, dtype=np.float32).reshape(3, 4), np.zeros((0, 2), np.int64), np.array(5, np.uint16),
    np.array([[True, False]]), np.int32(-3), np.uint64(2**63 + 5), np.float32(0.1), np.float64(2.5),
]


def test_wire_bytes_equal_for_every_type():
    for v in VALUES:
        b = twire.pack_value(v)
        assert b == jwire.pack_value(v), repr(v)
        got, want = twire.unpack_value(b), jwire.unpack_value(b)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want or (got != got and want != want), repr(v)
    out = bytearray(b"pre")
    assert twire.pack_value(1, out) == b"pre" + jwire.pack_value(1)
    for mod in (twire, jwire):
        for bad in (2**64, object(), {1.5: 0}):
            with pytest.raises(mod.WireError):
                mod.pack_value(bad)
        for junk in (b"\xfe\x01\x02", b"", b"\x04\xff\x00\x00\x00ab"):
            with pytest.raises(ValueError):
                mod.unpack_value(junk)


def _scenes(n=6, seed=0):
    """The same seeded networked scene in each package (the port's on the CPU)."""
    rng = np.random.default_rng(seed)
    rows = [(tuple(rng.uniform(-5, 5, 3)), tuple(rng.uniform(0.5, 2, 3)), i % 3 != 2) for i in range(n)]
    out = []
    for mod, sm, kw in ((jscene, jstate, {}), (tscene, tstate, {"device": "cpu"})):
        s = mod.Scene("net", spec=sm.SceneSpec(max_entities=32), **kw)
        for i, (pos, scale, networked) in enumerate(rows):
            e = s.create_entity(f"e{i}")
            e.add("TransformComponent", position=pos, scale=scale)
            if i % 2:
                e.add("SpriteComponent", layer=i, flip_x=True)
            if networked:
                e.add("Networked")
        out.append(s)
    return out


def _packets(mod, snap_mod, scene):
    b = snap_mod.SceneSnapshotBuilder()
    full = b.delta(b.take_snapshot(scene))
    b.ack(1)
    scene.set_field(1, "TransformComponent", "position", (9.0, 8.0, 7.0))
    scene.destroy_entity(3)
    inc = b.delta(b.take_snapshot(scene))
    return [
        mod.Handshake(client_name="alice"), mod.Handshake(), mod.ClientAck(sequence=42),
        mod.RPC.call("spawn_player", "alice", 3, [1.0, 2.0], {"k": np.arange(3)}, rpc_id=9),
        mod.RPC(name_hash=mod.fnv1a64("__rpc_ack"), params=[9]), mod.Disconnect("bye"),
        mod.SceneSnapshotPacket(full), mod.SceneSnapshotPacket(inc),
    ]


def test_packet_bytes_equal_for_every_kind():
    jsc, tsc = _scenes()
    jp, tp = _packets(jpkt, jsnap, jsc), _packets(tpkt, tsnap, tsc)
    assert {int(p.kind) for p in tp} == {int(k) for k in tpkt.PacketKind} == {int(k) for k in jpkt.PacketKind}
    assert tp[-1].delta.changed and tp[-1].delta.removed
    for j, t in zip(jp, tp):
        data = tpkt.encode_packet(t)
        assert data == jpkt.encode_packet(j), type(t).__name__
        back = tpkt.decode_packet(data)
        assert type(back).__name__ == type(t).__name__ and int(back.kind) == int(t.kind)
        assert tpkt.encode_packet(back) == data
    assert tpkt.fnv1a64("spawn_player") == jpkt.fnv1a64("spawn_player")
    for mod in (tpkt, jpkt):
        for junk in (b"\x00\x00\x00\x01hello", b"\x58\x4f\x00\x02\x00", b"X"):
            with pytest.raises(ValueError):
                mod.decode_packet(junk)


def pump_until(cond, *hosts, deadline=DEADLINE):
    end = time.monotonic() + deadline
    while True:
        for h in hosts:
            h.service()
        if cond():
            return True
        if time.monotonic() > end:
            return False
        time.sleep(0.002)


def _replica_equal(replica, src, emap):
    """The replica's networked component arrays equal the source's host mirror."""
    n = 0
    for i in np.nonzero(src._alive)[0]:
        i = int(i)
        if tsnap.C.BY_NAME["Networked"].path not in src._tags[i]:
            continue
        d = emap[i]
        assert replica._names[d] == src._names[i]
        for comp in tsnap.NETWORKED_COMPONENTS:
            assert bool(replica._comp_mask[comp][d]) == bool(src._comp_mask[comp][i]), comp
            if src._comp_mask[comp][i]:
                for f, arr in src._comp_data[comp].items():
                    if arr.dtype != object:
                        np.testing.assert_array_equal(replica._comp_data[comp][f][d], arr[i], err_msg=f"{comp}.{f}")
                n += 1
    return n


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_replication_across_packages(server_pkg):
    jsc, tsc = _scenes(seed=7)
    smod, cmod = (jman, tman) if server_pkg == "jax" else (tman, jman)
    src = jsc if server_pkg == "jax" else tsc
    replica = (tscene.Scene("replica", spec=tstate.SceneSpec(max_entities=32), device="cpu")
               if server_pkg == "jax" else jscene.Scene("replica", spec=jstate.SceneSpec(max_entities=32)))
    smgr, cmgr = smod.NetworkManager(), cmod.NetworkManager()
    try:
        server = smgr.create_server()
        client = cmgr.create_client("127.0.0.1", server.port, name="bob")
        client.replica_scene = replica
        calls, seen = [], []
        server.register_rpc("shoot", lambda peer, x, y: calls.append((peer.name, x, y)))
        client.register_rpc("hello", lambda peer, msg: seen.append(msg))
        hosts = (smgr, cmgr)
        step = lambda: [m.update() for m in hosts]
        svc = type("S", (), {"service": staticmethod(step)})
        assert pump_until(lambda: client.connected and len(server.peers) == 1, svc)
        assert next(iter(server.peers.values())).name == "bob"
        client.rpc("shoot", 1.5, 2.5)
        server.broadcast_rpc("hello", "hi")
        assert pump_until(lambda: calls and seen and not client.server.pending_rpcs
                          and not any(p.pending_rpcs for p in server.peers.values()), svc)
        assert calls == [("bob", 1.5, 2.5)] and seen == ["hi"]

        server.replicate(src)
        peer = next(iter(server.peers.values()))
        assert pump_until(lambda: peer.snapshots.last_acked == 1, svc)
        assert _replica_equal(replica, src, client.server.entity_map) >= 4
        src.set_field(1, "TransformComponent", "position", (1.0, 1.0, 1.0))
        src.destroy_entity(5)
        server.replicate(src)
        assert pump_until(lambda: peer.snapshots.last_acked == 2, svc)
        assert 5 not in client.server.entity_map
        assert _replica_equal(replica, src, client.server.entity_map) >= 3
        assert peer.bytes_sent > 0 and client.server.bytes_received == peer.bytes_sent
    finally:
        smgr.deinit()
        cmgr.deinit()


@pytest.mark.parametrize("pair", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_reliable_rpc_is_delivered_once(pair):
    mods = {"jax": jman, "port": tman}
    smgr, cmgr = mods[pair[0]].NetworkManager(), mods[pair[1]].NetworkManager()
    try:
        server = smgr.create_server()
        client = cmgr.create_client("127.0.0.1", server.port)
        got = []
        server.register_rpc("hit", lambda peer, n: got.append(n))
        svc = lambda: (server.service(), client.service())
        host = type("S", (), {"service": staticmethod(svc)})
        assert pump_until(lambda: client.connected, host)
        rid = client.rpc("hit", 1)
        assert rid == 1
        data, _ = client.server.pending_rpcs[rid]
        client._send_raw(client.server, data)  # a duplicate delivery
        client.rpc("hit", 2, reliable=False)
        assert pump_until(lambda: len(got) >= 2 and not client.server.pending_rpcs, host)
        time.sleep(0.02)
        server.service()
        assert sorted(got) == [1, 2]
        peer = next(iter(server.peers.values()))
        assert peer.seen_rpc_ids == {1}
        # an unacked RPC is resent after the interval until its ack arrives
        rid = client.rpc("hit", 3)
        server.sock.close()
        server.sock = None
        time.sleep(client.RPC_RESEND_INTERVAL + 0.01)
        sent = client.server.packets_sent
        client.service()
        assert client.server.packets_sent == sent + 1 and rid in client.server.pending_rpcs
    finally:
        if server.sock is None:
            smgr.servers.remove(server)
        smgr.deinit()
        cmgr.deinit()


@pytest.mark.parametrize("pair", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_disconnect_events(pair):
    mods = {"jax": jman, "port": tman}
    smgr, cmgr = mods[pair[0]].NetworkManager(), mods[pair[1]].NetworkManager()
    server = smgr.create_server()
    dropped = []
    server.on_peer_disconnected = lambda peer: dropped.append(peer.name)
    a = cmgr.create_client("127.0.0.1", server.port, name="ann")
    b = cmgr.create_client("127.0.0.1", server.port, name="ben")
    reasons = []
    b.on_disconnected = lambda reason: reasons.append(reason)
    svc = type("S", (), {"service": staticmethod(lambda: (smgr.update(), cmgr.update()))})
    assert pump_until(lambda: a.connected and b.connected and len(server.peers) == 2, svc)
    cmgr.destroy_client(a)
    assert pump_until(lambda: dropped == ["ann"], svc)
    assert [p.name for p in server.peers.values()] == ["ben"]
    smgr.deinit()
    assert pump_until(lambda: reasons == ["server shutdown"], b)
    assert not b.connected
    cmgr.deinit()

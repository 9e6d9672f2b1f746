"""Host logic around the redesigned banded and dense rigid-body kernels (one
persistent cooperative launch a call each, `physics/csrc/megakernel_banded.cu`
and `megakernel_dense.cu`), on the CPU: the dense kernel's cap statistics,
kept per (card, stream); the optional pass-cycle tensor's checks; the seeded
scene that `chip_smoke.py` phase 6 runs to put one body past the dense
kernel's cap; the scalar blocks the wrappers keep per (device, values), bit
for bit the blocks they made per call; and the wrappers' signatures and
refusals, which the redesign keeps. The kernels themselves run only on the card (`chip_smoke.py`)."""

import dataclasses
import inspect

import pytest
import torch

import chip_smoke
from oxylus_tpu_torch.flagship import build_flagship
from oxylus_tpu_torch.physics import megakernel as mk
from oxylus_tpu_torch.physics import megakernel_banded as mb
from oxylus_tpu_torch.physics.state import PhysicsParams, empty_physics_state

torch.set_num_threads(1)

DT = 1.0 / 60.0
CPU = torch.device("cpu")


def test_cap_stats_are_kept_per_card_and_stream():
    """Each (card, stream) has its own zeroed int32 pair [bodies past the cap,
    most partners], so calls on two streams never add into one; a key seen
    again gets its own tensor back."""
    saved = dict(mk._STATS)
    try:
        a, b = mk._stats(CPU, 21), mk._stats(CPU, 22)
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert mk._stats(CPU, 21) is a and mk._stats(torch.device("cpu"), 22) is b
        assert a.dtype == torch.int32 and a.shape == (2,) and a.tolist() == [0, 0] and b.tolist() == [0, 0]
        assert {(CPU, 21), (CPU, 22)} <= set(mk._STATS)
    finally:
        mk._STATS.clear()
        mk._STATS.update(saved)


@pytest.mark.parametrize("mod", [mb, mk], ids=["banded", "dense"])
def test_pass_cycles_tensor_is_checked(mod):
    """No tensor: a null pointer. Otherwise an int64 tensor with one entry per
    pass of the module's kernel, on the kernel's card, or a ValueError."""
    n = len(mod.PASSES)
    assert mb._cycles_ptr(None, n, CPU) is None
    ok = torch.zeros(n, dtype=torch.int64)
    assert mb._cycles_ptr(ok, n, CPU) == ok.data_ptr()
    for bad in (torch.zeros(n, dtype=torch.int32), torch.zeros(n + 1, dtype=torch.int64),
                torch.zeros(n, dtype=torch.int64, device="meta")):
        with pytest.raises(ValueError):
            mb._cycles_ptr(bad, n, CPU)


def test_cap_scene_puts_one_body_past_the_cap():
    """The premise of phase 6's cap check: in `chip_smoke.cap_scene` exactly
    one body (the plate, a dynamic box) has more AABB-overlapping partners
    than `megakernel.CAP`, some of them touching, and every other body has
    few; the flagship's own start state has none past the cap."""
    ps = build_flagship(device=CPU).physics_state
    cps = chip_smoke.cap_scene(ps)

    def counts(state):
        r = mk._input_rows(state)
        _, active, _, slots = mk.pair_contacts(r[0:3], r[9:13], r[17:20], r[20], r[21], r[28], r[29], r[31],
                                               mk.MARGIN)
        return active.sum(1), sum((active & (sl[3] > 0.0)).sum(1) for sl in slots)

    cnt, touching = counts(cps)
    past = torch.nonzero(cnt > mk.CAP).flatten().tolist()
    assert len(past) == 1
    plate = past[0]
    assert cps.body_type[plate] == ps.body_type[plate] and bool(cps.active[plate])
    assert cnt[plate] > 2 * mk.CAP and touching[plate] > 0
    assert int(torch.cat([cnt[:plate], cnt[plate + 1:]]).max()) <= 2
    assert int(counts(ps)[0].max()) <= mk.CAP


def _scalars_made_per_call(ps, params, dt, n_substeps, geom_every, plane_block):
    """The compact and banded kernels' scalar block as the wrappers made it
    before they kept it: every host scalar its own tensor."""
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=ps.device).reshape(1)
    sleep_v = t(params.sleep_velocity)
    return torch.cat([t(dt), t(params.gravity[0]), t(params.gravity[1]), t(params.gravity[2]), t(params.baumgarte),
                      t(params.penetration_slop), t(0.04 * geom_every), t(float(n_substeps)),
                      plane_block.to(torch.float32), sleep_v * sleep_v, t(params.sleep_time)])


@pytest.mark.parametrize("params", [PhysicsParams(), PhysicsParams(sleep_velocity=0.3337, sleep_time=0.04),
                                    PhysicsParams(gravity=(0.1, -9.7, 0.3), baumgarte=0.3, penetration_slop=0.01)])
def test_kept_scalar_blocks_have_the_same_bits(params):
    """The scalar blocks the wrappers now keep per (device, values) hold the
    bits the per-call tensors held (the sleep velocity squared in float32);
    a second call returns the kept tensor."""
    from oxylus_tpu_torch.physics import megakernel_compact as mc

    ps = build_flagship(n_boxes=40, spec_kw=dict(max_entities=512, max_bodies=256), device=CPU).physics_state
    planes, _ = mb.extract_hub_planes(ps)
    bits = lambda t: t.view(torch.int32)
    for dt, n, ge in ((DT, 60, 2), (1.0 / 120.0, 1, 1), (DT, 5, 3)):
        got = mc._scalar_block(ps, params, dt, n, ge, planes)
        assert torch.equal(bits(got), bits(_scalars_made_per_call(ps, params, dt, n, ge, planes)))
        t = lambda v: torch.as_tensor(v, dtype=torch.float32).reshape(-1)
        want = torch.cat([t(dt), t(params.gravity), t(params.baumgarte), t(params.penetration_slop), t(mk.MARGIN),
                          t(float(n))])
        dense = mk._scalar_block(ps, params, dt, n)
        assert torch.equal(bits(dense), bits(want)) and mk._scalar_block(ps, params, dt, n) is dense


def test_wrappers_keep_their_signatures():
    assert list(inspect.signature(mb.megakernel_substeps_banded).parameters) == [
        "ps", "params", "dt", "n_substeps", "iterations", "warm", "geom_every", "sleep"]
    assert list(inspect.signature(mk.megakernel_substeps).parameters) == [
        "ps", "params", "dt", "n_substeps", "iterations"]
    assert list(inspect.signature(mb.run_banded).parameters) == ["scalars", "rows", "kw"]
    assert list(inspect.signature(mk.run_dense).parameters) == ["scalars", "rows", "kw"]


def test_banded_refusals_are_unchanged():
    params = PhysicsParams()
    for capacity in (128, 320):  # below 256; not a multiple of 128
        with pytest.raises(ValueError):
            mb.megakernel_substeps_banded(empty_physics_state(capacity, device=CPU), params, DT)
    with pytest.raises(ValueError):
        mb.megakernel_substeps_banded(dataclasses.replace(empty_physics_state(256, device=CPU), has_proxies=True),
                                      params, DT)
    with pytest.raises(ValueError):  # neither the card nor the CPU: no implementation, no fallback
        mb.run_banded(torch.zeros(74, device="meta"), torch.zeros((36, 256), device="meta"), n_substeps=1,
                      iterations=1, warm=0.0, geom_every=1, sleep=False)


def test_dense_refusals_are_unchanged():
    params = PhysicsParams()
    with pytest.raises(ValueError):  # not a multiple of 64
        mk.megakernel_substeps(empty_physics_state(96, device=CPU), params, DT)
    with pytest.raises(ValueError):
        mk.megakernel_substeps(dataclasses.replace(empty_physics_state(128, device=CPU), has_proxies=True), params, DT)
    with pytest.raises(ValueError):
        mk.run_dense(torch.zeros(mk.N_SCALARS, device="meta"), torch.zeros((mk.N_ROWS, 128), device="meta"),
                     n_substeps=1, iterations=1)


def test_cpu_calls_count_no_launch_and_touch_no_statistics():
    """On the CPU both wrappers run their plain versions: no launch is
    counted and no cap statistics tensor is made."""
    ps = build_flagship(n_boxes=40, spec_kw=dict(max_entities=512, max_bodies=256), device=CPU).physics_state
    launches, banded_launches, stats = mk.LAUNCHES, mb.LAUNCHES, dict(mk._STATS)
    out = mk.megakernel_substeps(ps, PhysicsParams(), DT, n_substeps=1, iterations=2)
    outb = mb.megakernel_substeps_banded(ps, PhysicsParams(), DT, n_substeps=1, iterations=2)
    assert (mk.LAUNCHES, mb.LAUNCHES) == (launches, banded_launches) and mk._STATS == stats
    assert torch.isfinite(out.pos).all() and torch.isfinite(outb.pos).all()

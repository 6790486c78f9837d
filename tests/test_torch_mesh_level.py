"""The replicated-frontier mesh BFS's level pass as a stage of the mesh
hop (``ell_ops.mesh_hop`` with ``HOP_LEVEL``): one depth matrix, one
flags pair and the targets once a card group, the hop's frontier read
from the group's first replica and the new frontier written into every
replica.

Seeded numpy inputs go through the reference's
``make_sharded_batched_bfs_kernel`` (nebula_tpu/tpu/ell.py:1799) on a
``Mesh`` of the conftest's virtual CPU devices and through the port's
``ell_bfs_sharded`` on k CPU shards, whose hop and level stage run their
plain versions (``mesh_hop_ref``, ``mesh_level_ref``) on one card group
or on two pretended cards; depths are compared exactly, at k = 2 and 4,
stopping when the targets are found and not, for 1-5 levels and once
past 120 (the int16 form).  The levels run equal the single-card
``ell_bfs``'s and the per-replica plain program's
(``ell_bfs_sharded_ref``).  The stage alone equals ``bfs_level_ref`` on
every replica; the program keeps one depth matrix a group, reads the
targets from ``t0p`` itself and folds the level into each group's last
hop call.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, ell_from_reference,
                                      mesh_tables, pack_lanes_host)
from nebula_tpu_torch.tpu.mesh import PartsMesh

from test_torch_unpacked import _claim_a_spare, _graph

CPU = torch.device("cpu")
OVER = (1,)
LEVELS = [1, 2, 3, 4, 5, 130]       # 130: past 120, the int16 form


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    es_, hr = tix.hub_merge()
    return jix, tix, _t(es_), _t(hr)


def _lanes(tix, B, seed):
    rng = np.random.default_rng(seed)
    f = np.zeros((tix.n_rows + 1, B), bool)
    for q in range(B):
        f[tix.perm[rng.integers(0, tix.n)], q] = True
    return pack_lanes_host(f)


def _mesh(k, cards):
    """k CPU shards on one card group, or split over two pretended
    cards."""
    mesh = PartsMesh([CPU] * k)
    if cards == "two":
        half = (k + 1) // 2
        mesh.groups = ((CPU, tuple(range(half))), (CPU, tuple(range(half,
                                                                    k))))
    return mesh


@functools.lru_cache(maxsize=None)
def _jax_depths(k, max_steps, stop):
    """The reference's sharded BFS on the module's graph (its own ELL,
    rebuilt here so that the cache key stays hashable)."""
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    f0, t0 = _lanes(tix, 64, seed=k), _lanes(tix, 64, seed=k + 50)
    jmesh = Mesh(np.array(jax.devices()[:k]), ("parts",))
    nbrs, ets, reals = jell.shard_ell(jmesh, "parts", jix)
    bfs = jell.make_sharded_batched_bfs_kernel(
        jmesh, "parts", jix, max_steps, OVER, nbrs, ets, reals,
        stop_when_found=stop)
    je, jh = jix.hub_merge()
    return np.asarray(bfs(jnp.asarray(f0), jnp.asarray(t0),
                          jnp.asarray(je), jnp.asarray(jh), *nbrs, *ets))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("cards", ["one", "two"])
@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_steps", LEVELS)
def test_level_stage_bfs_matches_jax(ells, k, cards, stop, max_steps):
    """``ell_bfs_sharded`` with its level a stage of the hop (one depth
    matrix a card group) equals the reference's sharded kernel exactly;
    its levels equal the single-card BFS's and the per-replica plain
    program's, whose depths it also equals."""
    jix, tix, eslot, hrows = ells
    f0, t0 = _lanes(tix, 64, seed=k), _lanes(tix, 64, seed=k + 50)
    want = _jax_depths(k, max_steps, stop)
    assert want.dtype == (np.int8 if max_steps <= 120 else np.int16)
    mt = mesh_tables(tix, _mesh(k, cards))
    f0t, t0t = _t(f0), _t(t0)
    got, levels = ell_ops.ell_bfs_sharded(f0t, t0t, mt, [eslot] * k,
                                          [hrows] * k, OVER, max_steps,
                                          stop_when_found=stop)
    assert torch.equal(f0t, _t(f0)) and torch.equal(t0t, _t(t0))
    assert np.array_equal(got.numpy(), want)
    per, per_levels = ell_ops.ell_bfs_sharded_ref(
        _t(f0), _t(t0), mt, [eslot] * k, [hrows] * k, OVER, max_steps,
        stop_when_found=stop)
    one, one_levels = ell_ops.ell_bfs(_t(f0), _t(t0), tix.device_tables(CPU),
                                      eslot, hrows, OVER, max_steps,
                                      stop_when_found=stop)
    assert torch.equal(per, got) and torch.equal(one, got)
    assert levels == per_levels == one_levels
    assert levels <= max_steps


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("hop_first", [False, True])
@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
def test_level_stage_alone_equals_bfs_level_on_every_replica(ells, k,
                                                            hop_first,
                                                            dtype):
    """The stage (after a hop, or as the first pass) against
    ``bfs_level_ref`` run on every replica with a depth matrix each:
    the group's one matrix equals each of theirs, every replica holds
    their new frontier, and the flags agree; the first pass leaves the
    frontier as it was; a frontier already reached is cleared in every
    replica."""
    _jix, tix, eslot, hrows = ells
    mt = mesh_tables(tix, PartsMesh([CPU] * k))
    g = mt.mesh.groups[0]
    f0, t0 = _t(_lanes(tix, 32, seed=k)), _t(_lanes(tix, 32, seed=k + 9))
    R1, W = f0.shape
    cur = mt.mesh.replicas(f0)[0]
    nxt = torch.empty_like(cur)
    seen = torch.empty_like(f0)
    d = torch.empty((R1, 8 * W), dtype=dtype)
    flags = torch.zeros((3, 2), dtype=torch.int32)
    ell_ops.mesh_hop(nxt, cur, mt, g, eslot, hrows, OVER, ell_ops.HOP_LEVEL,
                     ell_ops.MeshLevel(t0, seen, d, flags[0], 0, True, True))
    assert all(torch.equal(r, f0) for r in cur)
    want_s, want_d = torch.empty_like(seen), torch.empty_like(d)
    want_f = torch.zeros((2,), dtype=torch.int32)
    ell_ops.bfs_level_ref(f0.clone(), t0, want_s, want_d, want_f, 0, True,
                          True)
    assert torch.equal(d, want_d) and torch.equal(flags[0], want_f)
    assert torch.equal(seen, want_s) and torch.equal(seen, f0)
    if not hop_first:
        return
    ell_ops.mesh_hop(cur, nxt, mt, g, eslot, hrows, OVER,
                     ell_ops.HOP_STAGES | ell_ops.HOP_LEVEL,
                     ell_ops.MeshLevel(t0, seen, d, flags[1], 0, False, True))
    hop = ell_ops.go_hop_ref(f0, None, torch.empty_like(f0),
                             tix.device_tables(CPU), eslot, hrows, OVER)[0]
    for s in range(k):          # the old path: the state and flags a shard
        rs, rd, rf, rn = want_s.clone(), want_d.clone(), \
            torch.zeros((2,), dtype=torch.int32), hop.clone()
        ell_ops.bfs_level_ref(rn, t0, rs, rd, rf, 0, False, True)
        assert torch.equal(nxt[s], rn)
        assert torch.equal(d, rd) and torch.equal(flags[1], rf)
        assert torch.equal(seen, rs)
    # the same frontier again: every bit is reached, so the stage clears
    # it in every replica and raises no frontier flag
    assert bool(nxt.any())
    ell_ops.mesh_hop(cur, nxt, mt, g, eslot, hrows, OVER, ell_ops.HOP_LEVEL,
                     ell_ops.MeshLevel(t0, seen, d, flags[2], 1, False, True))
    assert not bool(nxt.any()) and int(flags[2][0]) == 0
    assert torch.equal(d, rd) and torch.equal(seen, rs)


def test_the_program_keeps_one_depth_matrix_a_group(ells, monkeypatch):
    """Over two pretended cards: every level stage of a group gets the
    same reached bitmap and depth matrix and its own flags row, the
    targets are ``t0p`` itself, the first pass is the stage alone, and
    each later level rides the group's merge call (a card of one shard
    has no copy stage)."""
    _jix, tix, eslot, hrows = ells
    k = 3
    mt = mesh_tables(tix, _mesh(k, "two"))
    f0, t0 = _t(_lanes(tix, 32, seed=4)), _t(_lanes(tix, 32, seed=5))
    calls = []
    real = ell_ops.mesh_hop

    def hop(cur, nxt, mt_, group, *rest):
        stages = rest[3]
        lv = rest[4] if len(rest) > 4 else None
        calls.append((group[1], stages, lv))
        return real(cur, nxt, mt_, group, *rest)
    monkeypatch.setattr(ell_ops, "mesh_hop", hop)
    _d, levels = ell_ops.ell_bfs_sharded(f0, t0, mt, [eslot] * k,
                                         [hrows] * k, OVER, 4, False)
    assert levels >= 2
    H = ell_ops
    for members in ((0, 1), (2,)):
        mine = [(st_, lv) for m, st_, lv in calls if m == members]
        with_level = [(st_, lv) for st_, lv in mine if st_ & H.HOP_LEVEL]
        assert len(with_level) == levels + 1
        assert with_level[0][0] == H.HOP_LEVEL and with_level[0][1].first
        assert all(st_ == H.HOP_MERGE | H.HOP_LEVEL and not lv.first
                   for st_, lv in with_level[1:])
        assert [lv.step for _s, lv in with_level[1:]] == list(range(levels))
        assert len({lv.d.data_ptr() for _s, lv in with_level}) == 1
        assert len({lv.seen.data_ptr() for _s, lv in with_level}) == 1
        assert len({lv.flags.data_ptr() for _s, lv in with_level}) \
            == levels + 1
        assert all(lv.tp is t0 for _s, lv in with_level)
        copies = [st_ for st_, _lv in mine if st_ == H.HOP_COPY]
        assert len(copies) == (levels if len(members) > 1 else 0)


@pytest.mark.parametrize("bad", ["stage_without_operands",
                                 "operands_without_stage", "wrong_depth"])
def test_mesh_hop_checks_the_level_operands(ells, bad):
    _jix, tix, eslot, hrows = ells
    mt = mesh_tables(tix, PartsMesh([CPU] * 2))
    g = mt.mesh.groups[0]
    f0 = _t(_lanes(tix, 32, seed=1))
    R1, W = f0.shape
    cur = mt.mesh.replicas(f0)[0]
    nxt = torch.empty_like(cur)
    lv = ell_ops.MeshLevel(f0, torch.empty_like(f0),
                           torch.empty((R1, 8 * W), dtype=torch.int16),
                           torch.zeros((2,), dtype=torch.int32), 0, False,
                           True)
    args = {"stage_without_operands": (ell_ops.HOP_LEVEL, None),
            "operands_without_stage": (ell_ops.HOP_STAGES, lv),
            "wrong_depth": (ell_ops.HOP_LEVEL, lv._replace(
                d=torch.empty((R1, W), dtype=torch.int16)))}[bad]
    with pytest.raises(ValueError):
        ell_ops.mesh_hop(cur, nxt, mt, g, eslot, hrows, OVER, *args)

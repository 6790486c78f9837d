"""The windowed route's device programs (nebula_tpu_torch/tpu/ell_ops.py)
against the JAX functions they replace: the packed frontier upload
(``TpuQueryRuntime._upload_frontier_packed``, runtime.py:3251), batched
dense GO with its UPTO and COUNT(*) variants
(``make_batched_go_lanes_kernel``, ell.py:572) and batched BFS
(``make_batched_bfs_lanes_kernel``, ell.py:1080); then windowed GO
served end to end against a JAX cluster, on the dense route and, at
the default flags, on the sparse, split, adaptive and overflow-rerun
routes with ``| YIELD COUNT(*)`` and ``| LIMIT n``.

The same seeded numpy inputs go through the JAX function on CPU jax and
the port's wrapper on CPU torch (the plain route).  Bitsets, int8/int16
depths and int32 counts are compared for exact equality, over every one
of the ``n_rows + 1`` rows.  The ELL tables are the JAX package's own
numpy build at cap 8 with growth slack 8 (hub extra rows and unclaimed
growth spares present), carried into the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu.runtime import TpuQueryRuntime
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, INT16_INF,
                                      ell_from_reference)
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

CPU = torch.device("cpu")
OVER_SETS = [(1,), (-1,), (-1, 1, 2)]


def _graph(seed=11, n=300, m=1400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2),
    sparse enough that BFS runs several levels, with two hubs past
    cap 8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:60] = 5                        # hub by out-degree
    dst[60:110] = 9                     # hub by in-degree
    et = rng.integers(1, 3, m)
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    return es, ed, ee, n


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    jix = jell.EllIndex.build(es, ed, ee, n, cap=8, use_native=False,
                              growth_slack=8)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    assert len(jix.extra_owner) > 8     # hubs beyond the spares
    es_, hr = jix.hub_merge()
    port = dict(tables=tix.device_tables(CPU), eslot=_t(es_), hrows=_t(hr))
    ref = (jnp.asarray(es_), jnp.asarray(hr), *jix.kernel_args()[1:])
    return jix, tix, port, ref


@pytest.fixture(scope="module")
def rt():
    return TorchQueryRuntime(device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _starts(rng, tix, nq, per_query=3, dup=True):
    """Flat (new-id row, query col) start coordinates, with repeated
    pairs when ``dup``."""
    rows = tix.perm[rng.integers(0, tix.n, nq * per_query)]
    cols = np.repeat(np.arange(nq, dtype=np.int32), per_query)
    if dup:
        rows = np.concatenate([rows, rows[:5]])
        cols = np.concatenate([cols, cols[:5]])
    return rows.astype(np.int32), cols.astype(np.int32)


def _upload_both(rt, jix, tix, rows, cols, B):
    want = np.asarray(TpuQueryRuntime._upload_frontier_packed(
        jix, rows, cols, B))
    got = rt._upload_frontier_packed(tix, rows, cols, B)
    return want, got


# ================================================== frontier upload
@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("case", ["pairs", "duplicates", "empty"])
def test_upload_frontier_packed_matches_jax(ells, rt, B, case):
    jix, tix, _port, _ref = ells
    rng = np.random.default_rng(B)
    if case == "empty":
        rows = np.zeros(0, np.int32)
        cols = np.zeros(0, np.int32)
    else:
        rows, cols = _starts(rng, tix, min(B, 40), dup=case == "duplicates")
        cols = (cols * 7) % B           # spread over the lane words
    want, got = _upload_both(rt, jix, tix, rows, cols, B)
    assert got.dtype == torch.uint8
    assert np.array_equal(want, got.numpy())
    assert not got[-1].any()            # the pad row ends zero
    assert bool(got.any()) == (case != "empty")


# =========================================================== ell_go
@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["exact", "upto", "count"])
@pytest.mark.parametrize("over", OVER_SETS)
def test_ell_go_matches_jax(ells, rt, steps, mode, over):
    jix, tix, port, ref = ells
    B = 128
    rng = np.random.default_rng(steps * 10 + len(over))
    rows, cols = _starts(rng, tix, 37)
    f0 = np.asarray(TpuQueryRuntime._upload_frontier_packed(
        jix, rows, cols, B))
    count = mode == "count"
    upto = mode == "upto" or (count and steps % 2 == 0)
    kern = jell.make_batched_go_lanes_kernel(jix, steps, over, upto=upto,
                                             count=count, donate=False)
    if count:
        deg = rng.integers(0, 50, tix.n_rows + 1).astype(np.int32)
        deg[tix.n:] = 0                 # extras and the pad row count 0
        want = np.asarray(kern(jnp.asarray(f0), ref[0], ref[1],
                               jnp.asarray(deg), *ref[2:]))
        got = ell_ops.ell_go_count(_t(f0), _t(deg), over=over, steps=steps,
                                   upto=upto, **port)
        assert got.dtype == torch.int32 and got.shape == (B,)
    else:
        want = np.asarray(kern(jnp.asarray(f0), *ref))
        got = ell_ops.ell_go(_t(f0), over=over, steps=steps, upto=upto,
                             **port)
        assert got.shape == f0.shape
    assert np.array_equal(want, got.numpy())
    assert want.any()


def test_go_hop_without_accumulator_leaves_the_frontier_the_same(ells):
    """``accp=None`` skips only the union: the next frontier equals the
    accumulating hop's."""
    _jix, tix, port, _ref = ells
    rng = np.random.default_rng(2)
    f = rng.integers(0, 256, (tix.n_rows + 1, 16), dtype=np.uint8)
    f[-1] = 0
    acc = _t(f)
    out_a = torch.empty_like(acc)
    out_b = torch.empty_like(acc)
    ell_ops.go_hop(_t(f), acc, out_a, port["tables"], port["eslot"],
                   port["hrows"], (1,))
    got, none = ell_ops.go_hop(_t(f), None, out_b, port["tables"],
                               port["eslot"], port["hrows"], (1,))
    assert none is None
    assert torch.equal(out_a, out_b)
    assert torch.equal(acc, _t(f) | out_a)


# ========================================================== ell_bfs
@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_steps", [3, 121])
@pytest.mark.parametrize("over", [(1,), (-1, 1, 2)])
def test_ell_bfs_matches_jax(ells, stop, max_steps, over):
    jix, tix, port, ref = ells
    B = 128
    rng = np.random.default_rng(max_steps + 3 * stop + len(over))
    nq = 24
    rows, cols = _starts(rng, tix, nq, per_query=1, dup=False)
    trows, tcols = _starts(rng, tix, nq, per_query=2, dup=False)
    f0 = np.asarray(TpuQueryRuntime._upload_frontier_packed(
        jix, rows, cols, B))
    t0 = np.asarray(TpuQueryRuntime._upload_frontier_packed(
        jix, trows, tcols, B))
    kern = jell.make_batched_bfs_lanes_kernel(jix, max_steps, over,
                                              stop_when_found=stop)
    want = np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0), *ref))
    got, levels = ell_ops.ell_bfs(_t(f0), _t(t0), over=over,
                                  max_steps=max_steps,
                                  stop_when_found=stop, **port)
    small = max_steps <= 120
    assert want.dtype == (np.int8 if small else np.int16)
    assert got.dtype == (torch.int8 if small else torch.int16)
    assert got.shape == (tix.n_rows + 1, B)
    assert np.array_equal(want, got.numpy())
    unreached = -1 if small else int(INT16_INF)
    assert (want[-1] == unreached).all()          # the pad row
    assert 1 <= levels <= max_steps
    # the levels run are the deepest depth set, or one more when the
    # last level reached nothing new
    deepest = int(np.where(want == unreached, 0, want).max())
    assert levels in (deepest, deepest + 1)


def test_bfs_stops_at_the_level_the_targets_are_found(ells):
    """stop_when_found: one lane whose only target is a start's direct
    out-neighbour stops after one level; without it the BFS runs on."""
    jix, tix, port, ref = ells
    # a real row with an in-slot neighbour other than itself
    dst_row = src_row = None
    row0 = 0
    for nbr in tix.bucket_nbr:
        for i in range(nbr.shape[0]):
            live = nbr[i][(nbr[i] < tix.n) & (nbr[i] != row0 + i)]
            if row0 + i < tix.n and len(live) and dst_row is None:
                dst_row, src_row = row0 + i, int(live[0])
        row0 += nbr.shape[0]
    over = (-2, -1, 1, 2)
    f0 = np.zeros((tix.n_rows + 1, 16), np.uint8)
    t0 = np.zeros_like(f0)
    f0[src_row, 0] = 1
    t0[dst_row, 0] = 1
    kern = jell.make_batched_bfs_lanes_kernel(jix, 5, over,
                                              stop_when_found=True)
    want = np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0), *ref))
    got, levels = ell_ops.ell_bfs(_t(f0), _t(t0), over=over, max_steps=5,
                                  stop_when_found=True, **port)
    assert np.array_equal(want, got.numpy())
    assert levels == 1 and want[dst_row, 0] == 1
    _got, levels_all = ell_ops.ell_bfs(_t(f0), _t(t0), over=over,
                                       max_steps=5, stop_when_found=False,
                                       **port)
    assert levels_all > 1


# ================================================ wrapper contracts
def _kernel_calls(tix):
    R1 = tix.n_rows + 1
    f = torch.full((R1, 16), 0xFF, dtype=torch.uint8)
    i32 = torch.zeros(8, dtype=torch.int32)
    tables = tix.device_tables(CPU)
    R1w = (R1 + 31) // 32
    words = torch.full((R1w,), -1, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ids = torch.full((8,), tix.n_rows, dtype=torch.int32)
    ecnt, e0 = (_t(a) for a in tix.hub_expansion())
    deg = torch.zeros(R1, dtype=torch.int32)
    hub = _t(tix.hub_table().astype(np.uint8))
    eslot, hrows = (_t(a) for a in tix.hub_merge())
    lanes = torch.full((R1, 4), 0xFF, dtype=torch.uint8)
    return {
        "sparse_expand": (words, lambda: ell_ops.sparse_expand(
            ids, i32, ecnt, e0, tables, (1,), words, R1w, ctl, 1)),
        "pair_compact": (words, lambda: ell_ops.pair_compact(
            words, R1w, 8, i32.clone(), None, ctl, -1, tix.n_rows)),
        "pair_reduce": (lanes, lambda: ell_ops.pair_reduce(
            ell_ops.REDUCE_COUNT, ids, i32, deg,
            torch.zeros(2 + 8, dtype=torch.int32), True, R1, tix.n_rows,
            1, 8, 0, 0, ctl)),
        "adaptive_switch": (lanes, lambda: ell_ops.adaptive_switch(
            ids, hub, tix.n, tix.n_rows, ctl)),
        "bitmap_lanes": (lanes, lambda: ell_ops.bitmap_lanes(
            True, words, lanes, R1)),
        "sparse_go": (words, lambda: ell_ops.sparse_go(
            ids, i32, ecnt, e0, deg, tables, (1,), 3, (8, 64, 64), 1024,
            1, upto=True)),
        "adaptive_go": (lanes, lambda: ell_ops.adaptive_go(
            ids[:2], hub, tables, eslot, hrows, (1,), 3)),
        "frontier_upload": (f, lambda: ell_ops.frontier_upload(
            f, torch.zeros((2, 8), dtype=torch.int32))),
        "go_count": (f, lambda: ell_ops.go_count(
            f, torch.zeros(R1, dtype=torch.int32),
            torch.zeros(128, dtype=torch.int32))),
        "bfs_level": (f, lambda: ell_ops.bfs_level(
            f, f.clone(), f.clone(),
            torch.zeros((R1, 128), dtype=torch.int16),
            torch.zeros(2, dtype=torch.int32), 0)),
        "bfs_depth_i8": (f, lambda: ell_ops.bfs_depth_i8(
            torch.zeros((R1, 128), dtype=torch.int16),
            torch.zeros((R1, 128), dtype=torch.int8))),
    }


@pytest.mark.parametrize("name", ["frontier_upload", "go_count",
                                  "bfs_level", "bfs_depth_i8",
                                  "sparse_expand", "pair_compact",
                                  "pair_reduce", "adaptive_switch",
                                  "bitmap_lanes", "sparse_go",
                                  "adaptive_go"])
def test_new_kernel_routes_never_fall_back(ells, monkeypatch, name):
    """On the kernel route a wrapper whose library cannot load raises,
    counts no launch and leaves its buffers untouched."""
    _jix, tix, _port, _ref = ells
    buf, call = _kernel_calls(tix)[name]
    fill = buf.clone()

    def no_lib():
        raise RuntimeError("kernel library unavailable")
    monkeypatch.setattr(ell_ops, "_route", lambda dev: True)
    monkeypatch.setattr(ell_ops, "_lib", no_lib)
    before = dict(ell_ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="unavailable"):
        call()
    assert torch.equal(buf, fill)
    assert ell_ops.LAUNCHES == before


def test_new_wrappers_reject_bad_operands(ells):
    _jix, tix, _port, _ref = ells
    R1 = tix.n_rows + 1
    f = torch.zeros((R1, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):       # coords must be int32
        ell_ops.frontier_upload(f, torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError):      # counts has 8W lanes
        ell_ops.go_count(f, torch.zeros(R1, dtype=torch.int32),
                         torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError):      # d has 8W lanes per row
        ell_ops.bfs_level(f, f, f.clone(),
                          torch.zeros((R1, 64), dtype=torch.int16),
                          torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):      # depths must fit int16
        ell_ops.ell_bfs(f, f.clone(), _port["tables"], _port["eslot"],
                        _port["hrows"], (1,), 1 << 15)


# ============================================ served end to end
N_VERTICES = 90
WINDOWED = {"go_dispatch_mode": "windowed", "tpu_sparse_go": False,
            "tpu_adaptive_single": False}


def _set_flags(registry, values):
    """Set ``values`` on a flag registry; returns the old values."""
    old = {k: registry.get(k) for k in values}
    for k, v in values.items():
        assert registry.set(k, v), k
    return old


def _cluster_edges(seed=23, n=N_VERTICES, m=480):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, m)
    dst = rng.integers(1, n + 1, m)
    src[:40] = 1                         # out-hub: spills past cap 8
    dst[40:75] = 2                       # in-hub
    keep = src != dst
    return src[keep], dst[keep]


@pytest.fixture(scope="module")
def windowed():
    """(ok, port runtime, space, etype): a JAX cluster and a port runtime
    over the cluster's mirror, both in windowed mode with the sparse and
    adaptive routes off."""
    from nebula_tpu.cluster import LocalCluster
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
    c = LocalCluster(num_storage=1, tpu_backend=True)
    # both sides build the same ELL tables (cap 8: hub extra rows), so
    # a device-cut LIMIT keeps the same rows on both
    old_ref = _set_flags(ref_flags, dict(WINDOWED, tpu_ell_cap=8))
    old = _set_flags(flags, dict(WINDOWED, tpu_ell_cap=8))
    rt_ = None
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE w(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE w")
        ok("CREATE EDGE e(w int)")
        c.refresh_all()
        src, dst = _cluster_edges()
        ok("INSERT EDGE e(w) VALUES " + ", ".join(
            f"{a} -> {b}:({(a + b) % 7})" for a, b in zip(src, dst)))
        ok("GO 2 STEPS FROM 1 OVER e")
        space = next(iter(c.tpu_runtime.mirrors))
        m = c.tpu_runtime.mirror(space)
        et = int(np.abs(m.edge_etype).max())
        rt_ = TorchQueryRuntime(device="cpu")
        rt_.load_space(space, mirror_from_reference(
            {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space))
        ok.cluster = c
        yield ok, rt_, space, et
    finally:
        if rt_ is not None:
            rt_.close()
        c.stop()
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


def _go_mix(rng, n_queries):
    """(ngql, starts, steps, upto, count, reverse) tuples: 1-4 steps,
    1-4 start vids, UPTO, COUNT(*), REVERSELY."""
    out = []
    for i in range(n_queries):
        starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                               int(rng.integers(1, 5)))]
        if i % 11 == 3:
            starts.append(10 ** 6)       # an absent vid drops
        steps = int(rng.integers(1, 5))
        upto = bool(rng.random() < 0.35) and steps > 1
        count = bool(rng.random() < 0.35)
        reverse = bool(rng.random() < 0.25)
        q = (f"GO {'UPTO ' if upto else ''}{steps} STEPS FROM "
             f"{','.join(map(str, starts))} OVER e"
             f"{' REVERSELY' if reverse else ''} YIELD e._dst"
             f"{' | YIELD COUNT(*)' if count else ''}")
        out.append((q, starts, steps, upto, count, reverse))
    return out


def _serve(rt_, space, et, spec):
    _q, starts, steps, upto, count, reverse = spec
    e = -et if reverse else et
    return rt_.serve_go(space, starts, [e], steps, {e: "e"}, upto=upto,
                        reduce=("count",) if count else None)


def test_windowed_go_matches_cluster(windowed):
    ok, rt_, space, et = windowed
    for spec in _go_mix(np.random.default_rng(31), 24):
        cols, rows = _serve(rt_, space, et, spec)
        assert cols == (["__count__"] if spec[4] else ["e._dst"]), spec[0]
        assert sorted(map(tuple, rows)) == \
            sorted(map(tuple, ok(spec[0]).rows)), spec[0]
    assert rt_.continuous.streams() == []        # nothing rode a stream
    assert rt_.stats["go_dense"] > 0


def test_concurrent_windowed_go_coalesces_and_matches(windowed):
    """More submitters than cores, over few shape keys, with a fixed
    pooling window and a short thread switch interval: the dispatcher
    coalesces, counts every query once, and every answer equals the
    cluster's."""
    import os
    import sys
    import threading

    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et = windowed
    rng = np.random.default_rng(5)
    mix = [spec for spec in _go_mix(rng, 200)
           if spec[2] == 3 and not spec[5]][:40]
    want = [sorted(map(tuple, ok(spec[0]).rows)) for spec in mix]
    got = [None] * len(mix)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= len(mix):
                return
            try:
                got[i] = sorted(map(tuple, _serve(rt_, space, et,
                                                  mix[i])[1]))
            except Exception as ex:     # noqa: BLE001 — asserted below
                errors.append((mix[i][0], ex))

    old = _set_flags(flags, {"go_batch_window_ms": 30})
    before = dict(rt_.dispatcher.stats)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool = [threading.Thread(target=worker)
                for _ in range(2 * (os.cpu_count() or 4))]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
        _set_flags(flags, old)
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors
    assert got == want
    stats = rt_.dispatcher.stats
    assert stats["batched_queries"] - before["batched_queries"] == len(mix)
    assert stats["batches"] - before["batches"] < len(mix)
    assert stats["max_batch"] > 1


def test_continuous_and_windowed_answers_agree(windowed):
    """The windowed route is the continuous path's parity oracle: the
    same multi-hop mix through both modes gives the same rows."""
    from nebula_tpu_torch.common.flags import flags
    _ok, rt_, space, et = windowed
    mix = [s for s in _go_mix(np.random.default_rng(41), 30) if s[2] > 1]
    windowed_rows = [sorted(map(tuple, _serve(rt_, space, et, s)[1]))
                     for s in mix]
    old = _set_flags(flags, {"go_dispatch_mode": "continuous"})
    try:
        cont_rows = [sorted(map(tuple, _serve(rt_, space, et, s)[1]))
                     for s in mix]
        assert rt_.continuous.streams()          # they rode a stream
    finally:
        _set_flags(flags, old)
    assert cont_rows == windowed_rows


SERVED_ROUTES = {"sparse_go": "go_sparse", "adaptive_go": "go_adaptive",
                 "unpacked ell_go": "go_dense",
                 "mesh_sparse_go": "go_mesh_sparse"}


@pytest.mark.parametrize("setting,starts,needs", [
    ({"tpu_sparse_go": True}, [1, 2], "sparse_go"),
    ({"tpu_adaptive_single": True}, [1], "adaptive_go"),
    ({"tpu_mesh_devices": 2}, [1, 2], "mesh_sparse_go"),
    ({"tpu_packed_frontier": False}, [1, 2], "unpacked ell_go"),
])
def test_unported_routes_decline_naming_their_kernel(windowed, setting,
                                                     starts, needs):
    """Every route serves now: the sparse, adaptive and unpacked routes
    and the mesh in the default tpu_mesh_mode=sparse (mesh_sparse_go);
    each one's counter moves and the rows equal the cluster's.  A route
    not in SERVED_ROUTES would have to decline naming its kernel."""
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.storage.device import TpuDecline
    ok, rt_, space, et = windowed
    old = _set_flags(flags, setting)
    try:
        if needs in SERVED_ROUTES:
            before = rt_.stats[SERVED_ROUTES[needs]]
            cols, rows = rt_.serve_go(space, starts, [et], 3, {et: "e"})
            assert rt_.stats[SERVED_ROUTES[needs]] == before + 1
            want = ok(f"GO 3 STEPS FROM {','.join(map(str, starts))} "
                      f"OVER e YIELD e._dst").rows
            assert cols == ["e._dst"] and rows == want
        else:
            with pytest.raises(TpuDecline, match=needs):
                rt_.serve_go(space, starts, [et], 3, {et: "e"})
    finally:
        _set_flags(flags, old)
    # single-step GO needs no kernel and is served on every route
    old = _set_flags(flags, setting)
    try:
        cols, _rows = rt_.serve_go(space, starts, [et], 1, {et: "e"})
    finally:
        _set_flags(flags, old)
    assert cols == ["e._dst"]


def test_go_batch_tool_surface_matches_a_host_walk(windowed):
    """``go_batch`` (the tool and bench surface) gives bool [B, n]
    frontiers after ``steps`` advances, as a plain walk of the mirror
    does."""
    _ok, rt_, space, et = windowed
    rng = np.random.default_rng(9)
    starts = [[int(v) for v in rng.integers(1, N_VERTICES + 1, 2)]
              for _ in range(20)]
    got = rt_.go_batch(space, starts, [et], 2)
    m = rt_.mirror(space)
    assert got.shape == (20, m.n) and got.any()
    # the same frontiers from the port's own host walk of the mirror
    mask = m.edge_etype == et
    for q, s in enumerate(starts):
        f = np.zeros(m.n, bool)
        f[m.to_dense(s)] = True
        for _ in range(2):
            nxt = np.zeros(m.n, bool)
            nxt[m.edge_dst[mask & f[m.edge_src]]] = True
            f = nxt
        assert np.array_equal(got[q], f)


# ==================================== served at the default flags
DEFAULT_ROUTES = {"tpu_sparse_go": True, "tpu_adaptive_single": True}


@pytest.fixture
def default_flags(windowed):
    """The windowed fixture with the sparse and adaptive routes at their
    default (on) on both the cluster and the port, which share one ELL
    layout; yields (ok, port runtime, space, etype, cluster runtime)."""
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et = windowed
    ref_rt = ok.cluster.tpu_runtime
    ref_ix = ref_rt.ell(ref_rt.mirror(space))
    assert np.array_equal(ref_ix.perm, rt_.ell(rt_.mirror(space)).perm)
    old_ref = _set_flags(ref_flags, DEFAULT_ROUTES)
    old = _set_flags(flags, DEFAULT_ROUTES)
    try:
        yield ok, rt_, space, et, ref_rt
    finally:
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


def _limit_mix(rng, n_queries):
    """_go_mix with ``| LIMIT n`` on a third of the plain exact-depth
    requests: (ngql, starts, steps, upto, count, reverse, limit)."""
    out = []
    for i, spec in enumerate(_go_mix(rng, n_queries)):
        q, starts, steps, upto, count, reverse = spec
        limit = None
        if not (upto or count) and i % 3 == 0:
            limit = int(rng.integers(1, 7))
            q = f"{q} | LIMIT {limit}"
        out.append((q, starts, steps, upto, count, reverse, limit))
    return out


def _serve_limited(rt_, space, et, spec):
    _q, starts, steps, upto, count, reverse, limit = spec
    e = -et if reverse else et
    return rt_.serve_go(space, starts, [e], steps, {e: "e"}, upto=upto,
                        reduce=("count",) if count else None, limit=limit)


def test_default_flags_go_matches_cluster_in_order(default_flags):
    """GO, GO | YIELD COUNT(*) and GO | LIMIT n one request at a time:
    both sides take the same (sparse or adaptive) route, so even the
    device-cut LIMIT rows are equal in order."""
    ok, rt_, space, et, ref_rt = default_flags
    before = dict(rt_.stats)
    ref_before = dict(ref_rt.stats)
    mix = _limit_mix(np.random.default_rng(37), 45)
    assert sum(s[6] is not None for s in mix) >= 5
    for spec in mix:
        cols, rows = _serve_limited(rt_, space, et, spec)
        want = ok(spec[0]).rows
        assert cols == (["__count__"] if spec[4] else ["e._dst"]), spec[0]
        if spec[4] and not want:          # COUNT over no rows: no row
            assert rows == [[0]], spec[0]
        else:
            assert rows == want, spec[0]
    assert rt_.stats["go_sparse"] > before["go_sparse"]
    assert ref_rt.stats["go_sparse"] > ref_before["go_sparse"]
    assert rt_.stats["go_reduced"] > before["go_reduced"]
    assert rt_.stats["go_dense"] == before["go_dense"]
    # a lone query with no known start vid: the adaptive route
    cols, rows = rt_.serve_go(space, [10 ** 6], [et], 3, {et: "e"})
    assert rows == ok("GO 3 STEPS FROM 1000000 OVER e YIELD e._dst").rows
    assert rows == [] and rt_.stats["go_adaptive"] == \
        before["go_adaptive"] + 1


def test_default_flags_concurrent_go_matches_cluster(default_flags):
    """A concurrent mix (no LIMIT) coalesces into sparse launches whose
    rows, compared as sorted rows, equal the cluster's."""
    import threading

    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et, _ref_rt = default_flags
    mix = [s for s in _go_mix(np.random.default_rng(43), 60)
           if s[2] == 3 and not s[5]][:30]
    want = [sorted(map(tuple, ok(s[0]).rows)) for s in mix]
    got = [None] * len(mix)
    errors = []

    def worker(i):
        try:
            got[i] = sorted(map(tuple, _serve(rt_, space, et, mix[i])[1]))
        except Exception as ex:     # noqa: BLE001 — asserted below
            errors.append((mix[i][0], ex))

    old = _set_flags(flags, {"go_batch_window_ms": 30})
    before = dict(rt_.dispatcher.stats)
    sparse0 = rt_.stats["go_sparse"]
    try:
        pool = [threading.Thread(target=worker, args=(i,))
                for i in range(len(mix))]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        _set_flags(flags, old)
    assert not errors, errors
    assert got == want
    stats = rt_.dispatcher.stats
    assert stats["batches"] - before["batches"] < len(mix)
    assert rt_.stats["go_sparse"] > sparse0


@pytest.mark.parametrize("reduce", [None, "upto", ("count",), "limit"])
def test_forced_split_matches_cluster(default_flags, reduce):
    """tpu_sparse_c0s="4,8": a batch of 12 queries with 2-3 starts each
    outgrows the ladder and splits into sparse launches at query
    boundaries; every query's rows equal the cluster's (for LIMIT the
    first n rows the pipe keeps)."""
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.filter.expressions import EdgeDstIdExpr
    from nebula_tpu_torch.tpu.runtime import _GoQuery, _YieldCol
    ok, rt_, space, et, _ref_rt = default_flags
    plan = rt_._plan_go(space, {"e": et}, None, True)
    ydst = [_YieldCol(EdgeDstIdExpr("e"), None)]
    rng = np.random.default_rng(53)
    starts = [[int(v) for v in rng.integers(1, N_VERTICES + 1,
                                            int(rng.integers(2, 4)))]
              for _ in range(12)]
    upto = reduce == "upto"
    red = ("limit", 4) if reduce == "limit" else \
        (reduce if isinstance(reduce, tuple) else None)
    old = _set_flags(flags, {"tpu_sparse_c0s": "4,8"})
    split0 = rt_.stats["go_sparse_split"]
    try:
        pending = rt_.go_batch_execute(
            space, [_GoQuery(s, plan, ydst, False, None, {et: "e"})
                    for s in starts], (et,), 3,
            upto=upto, reduce=red)
        results, _m = pending.finish()
    finally:
        _set_flags(flags, old)
    assert rt_.stats["go_sparse_split"] == split0 + 1
    for s, (cols, rows) in zip(starts, results):
        q = (f"GO {'UPTO ' if upto else ''}3 STEPS FROM "
             f"{','.join(map(str, s))} OVER e YIELD e._dst")
        if reduce == ("count",):
            want = ok(q + " | YIELD COUNT(*)").rows or [[0]]
        elif reduce == "limit":
            want = ok(q + " | LIMIT 4").rows
            rows = rows[:4]
        else:
            want = ok(q).rows
        assert rows == want, q


def test_forced_overflow_reruns_dense_and_matches(default_flags):
    """A tight tpu_sparse_cap on both sides: hops outgrow their caps,
    the batch reruns on the dense route, and every answer (LIMIT
    included: both sides cut the dense rows the same way) equals the
    cluster's."""
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et, ref_rt = default_flags
    tight = {"tpu_sparse_c0s": "8,64", "tpu_sparse_cap": 8}
    mix = [s for s in _limit_mix(np.random.default_rng(59), 30)
           if s[2] >= 3]
    old_ref = _set_flags(ref_flags, tight)
    old = _set_flags(flags, tight)
    before = dict(rt_.stats)
    try:
        for spec in mix:
            cols, rows = _serve_limited(rt_, space, et, spec)
            want = ok(spec[0]).rows
            if spec[4] and not want:
                assert rows == [[0]], spec[0]
            else:
                assert rows == want, spec[0]
    finally:
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)
    assert rt_.stats["sparse_overflows"] > before["sparse_overflows"]
    assert rt_.stats["go_dense"] > before["go_dense"]
    assert ref_rt.stats["sparse_overflows"] > 0


def test_upto_with_a_cap_below_the_start_rung_runs_dense(default_flags):
    """A final sparse cap smaller than the start rung leaves no room to
    pad the UPTO union's starts: the batch takes the dense route."""
    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et, _ref_rt = default_flags
    old = _set_flags(flags, {"tpu_sparse_cap": 8})
    before = dict(rt_.stats)
    try:
        cols, rows = rt_.serve_go(space, [1, 2], [et], 3, {et: "e"},
                                  upto=True)
    finally:
        _set_flags(flags, old)
    assert rt_.stats["go_dense"] == before["go_dense"] + 1
    assert rt_.stats["go_sparse"] == before["go_sparse"]
    assert sorted(map(tuple, rows)) == sorted(map(tuple, ok(
        "GO UPTO 3 STEPS FROM 1,2 OVER e YIELD e._dst").rows))


def test_limit_in_continuous_mode_matches_cluster(default_flags):
    """GO | LIMIT n in continuous mode rides the stream with the full
    frontier and the same slice as the cluster's continuous tier."""
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    ok, rt_, space, et, _ref_rt = default_flags
    mix = [s for s in _limit_mix(np.random.default_rng(61), 36)
           if s[6] is not None and s[2] > 1]
    assert len(mix) >= 4
    cont = {"go_dispatch_mode": "continuous"}
    old_ref = _set_flags(ref_flags, cont)
    old = _set_flags(flags, cont)
    reduced0 = rt_.stats["go_reduced"]
    try:
        for spec in mix:
            cols, rows = _serve_limited(rt_, space, et, spec)
            assert cols == ["e._dst"]
            assert rows == ok(spec[0]).rows, spec[0]
        assert rt_.continuous.streams()
    finally:
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)
    assert rt_.stats["go_reduced"] >= reduced0 + len(mix)


def test_limit_declines_with_upto_or_a_reduction(default_flags):
    from nebula_tpu_torch.storage.device import TpuDecline
    _ok, rt_, space, et, _ref_rt = default_flags
    for kw in ({"upto": True}, {"reduce": ("count",)}):
        with pytest.raises(TpuDecline, match="LIMIT"):
            rt_.serve_go(space, [1], [et], 3, {et: "e"}, limit=3, **kw)
    cols, rows = rt_.serve_go(space, [1], [et], 3, {et: "e"}, limit=0)
    assert cols == ["e._dst"] and rows == []

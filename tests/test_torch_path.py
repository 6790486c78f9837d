"""FIND PATH through the port against the JAX cluster: the same
``FIND SHORTEST|ALL PATH`` statements on a reference ``LocalCluster``
and on ``TorchQueryRuntime.serve_find_path`` (CPU torch, plain kernel
versions) over the cluster's mirror, carried across.  Multi-source and
multi-target lists, UPTO 2..4 STEPS, sequential and concurrent; sorted
rows must be equal.  The batched BFS depths (``bfs_batch``) are held
to the JAX runtime's over the whole vertex set.  FIND PATH is served at
default flags: it always rides the dispatcher's windowed tier.
"""
import threading

import numpy as np
import pytest

from nebula_tpu.cluster import LocalCluster
from nebula_tpu_torch.common.flags import flags
from nebula_tpu_torch.storage.device import TpuDecline
from nebula_tpu_torch.tpu import runtime as truntime
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

N_VERTICES = 120


def _edges(seed=29, n=N_VERTICES, m=330):
    """Sparse enough that shortest paths run several levels, with an
    out-hub and an in-hub past cap 8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, m)
    dst = rng.integers(1, n + 1, m)
    src[:30] = 1
    dst[30:55] = 2
    keep = src != dst
    return src[keep], dst[keep]


@pytest.fixture(scope="module")
def paths():
    """(ok, port runtime, space, etype, JAX runtime)."""
    old_cap = flags.get("tpu_ell_cap")
    flags.set("tpu_ell_cap", 8)
    c = LocalCluster(num_storage=1, tpu_backend=True)
    rt = None
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE p(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE p")
        ok("CREATE EDGE e(w int)")
        c.refresh_all()
        src, dst = _edges()
        ok("INSERT EDGE e(w) VALUES " + ", ".join(
            f"{a} -> {b}:({a % 5})" for a, b in zip(src, dst)))
        ok("FIND SHORTEST PATH FROM 1 TO 2 OVER e UPTO 3 STEPS")
        space = next(iter(c.tpu_runtime.mirrors))
        m = c.tpu_runtime.mirror(space)
        et = int(np.abs(m.edge_etype).max())
        rt = TorchQueryRuntime(device="cpu")
        rt.load_space(space, mirror_from_reference(
            {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space))
        yield ok, rt, space, et, c.tpu_runtime
    finally:
        if rt is not None:
            rt.close()
        c.stop()
        flags.set("tpu_ell_cap", old_cap)


def _queries(rng, n, shortest, steps_range=(2, 5)):
    """(ngql, srcs, dsts, steps) tuples with 1-3 srcs and 1-3 dsts."""
    out = []
    kind = "SHORTEST" if shortest else "ALL"
    for i in range(n):
        srcs = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 4)))]
        dsts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 4)))]
        if i % 7 == 2:
            dsts.append(10 ** 6)         # an absent vid drops
        steps = int(rng.integers(*steps_range))
        q = (f"FIND {kind} PATH FROM {','.join(map(str, srcs))} TO "
             f"{','.join(map(str, dsts))} OVER e UPTO {steps} STEPS")
        out.append((q, srcs, dsts, steps))
    return out


def _port(rt, space, et, spec, shortest):
    _q, srcs, dsts, steps = spec
    return rt.serve_find_path(space, srcs, dsts, [et], steps, shortest,
                              {et: "e"})


def _rows(r):
    return sorted(map(tuple, r.rows))


@pytest.mark.parametrize("shortest", [True, False])
def test_find_path_matches_cluster(paths, shortest):
    ok, rt, space, et, _jrt = paths
    steps_range = (2, 5) if shortest else (2, 4)
    specs = _queries(np.random.default_rng(3 + shortest), 18, shortest,
                     steps_range)
    found = 0
    for spec in specs:
        cols, rows = _port(rt, space, et, spec, shortest)
        assert cols == ["path"]
        want = _rows(ok(spec[0]))
        assert sorted(map(tuple, rows)) == want, spec[0]
        found += len(want)
    assert found > 0


def test_find_all_path_four_steps_matches_cluster(paths):
    ok, rt, space, et, _jrt = paths
    spec = ("FIND ALL PATH FROM 3,4 TO 5 OVER e UPTO 4 STEPS", [3, 4], [5],
            4)
    cols, rows = _port(rt, space, et, spec, False)
    assert sorted(map(tuple, rows)) == _rows(ok(spec[0]))


def test_concurrent_find_path_coalesces_and_matches(paths):
    ok, rt, space, et, _jrt = paths
    specs = [s for s in _queries(np.random.default_rng(8), 60, True)
             if s[3] == 3][:24]
    want = [_rows(ok(s[0])) for s in specs]
    got = [None] * len(specs)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= len(specs):
                return
            try:
                got[i] = sorted(map(tuple, _port(rt, space, et, specs[i],
                                                 True)[1]))
            except Exception as ex:     # noqa: BLE001 — asserted below
                errors.append((specs[i][0], ex))

    old = flags.get("go_batch_window_ms")
    flags.set("go_batch_window_ms", 30)
    before = dict(rt.dispatcher.stats)
    try:
        pool = [threading.Thread(target=worker) for _ in range(6)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        flags.set("go_batch_window_ms", old)
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors
    assert got == want
    assert rt.dispatcher.stats["batches"] - before["batches"] < len(specs)
    assert rt.stats["bfs_levels"] > 0 and rt.stats["path_device"] > 0


@pytest.mark.parametrize("shortest", [True, False])
@pytest.mark.parametrize("max_steps", [3, 121])
def test_bfs_batch_matches_jax_runtime(paths, shortest, max_steps):
    _ok, rt, space, et, jrt = paths
    rng = np.random.default_rng(max_steps + shortest)
    starts = [[int(v) for v in rng.integers(1, N_VERTICES + 1, 2)]
              for _ in range(10)]
    targets = [[int(v) for v in rng.integers(1, N_VERTICES + 1, 2)]
               for _ in range(10)]
    want = jrt.bfs_batch(space, starts, targets, [et], max_steps,
                         shortest=shortest)
    got = rt.bfs_batch(space, starts, targets, [et], max_steps,
                       shortest=shortest)
    assert got.dtype == np.int16 and want.dtype == np.int16
    assert np.array_equal(got, want)
    assert (got < truntime.INT16_INF).sum() > len(starts)


def test_in_edge_cache_keeps_the_reference_order(paths):
    """The cached OVER-set in-edge view lists each vertex's edges in the
    order the reference's per-call argsort walks them."""
    _ok, rt, space, et, _jrt = paths
    m = rt.mirror(space)
    order, sorted_dst = rt._in_edges(m, (et,))
    ref_order = np.argsort(m.edge_dst, kind="stable")
    ref_order = ref_order[m.edge_etype[ref_order] == et]
    assert np.array_equal(order, ref_order)
    assert np.array_equal(sorted_dst, m.edge_dst[ref_order])
    assert rt._in_edges(m, (et,))[0] is order       # cached


def test_find_path_declines(paths):
    """An unloaded space declines; the mesh route in the default
    tpu_mesh_mode=sparse (``mesh_sparse_bfs``) and, with packing off,
    the int8 route serve the path, and their rows equal the
    cluster's."""
    ok, rt, space, et, _jrt = paths
    with pytest.raises(TpuDecline):
        rt.serve_find_path(space + 99, [1], [2], [et], 3, True, {et: "e"})
    for setting, mesh_runs in (({"tpu_mesh_devices": 2}, 1),
                               ({"tpu_packed_frontier": False}, 0)):
        (k, v), = setting.items()
        old = flags.get(k)
        flags.set(k, v)
        before = rt.stats["bfs_mesh_sparse"]
        try:
            cols, rows = rt.serve_find_path(space, [1], [2], [et], 3, True,
                                            {et: "e"})
        finally:
            flags.set(k, old)
        assert cols == ["path"] and sorted(map(tuple, rows)) == \
            _rows(ok("FIND SHORTEST PATH FROM 1 TO 2 OVER e UPTO 3 STEPS"))
        assert rt.stats["bfs_mesh_sparse"] == before + mesh_runs
    # empty endpoint lists answer no rows without touching the card
    assert rt.serve_find_path(space, [], [2], [et], 3, True,
                              {et: "e"}) == (["path"], [])

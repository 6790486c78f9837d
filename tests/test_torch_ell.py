"""The port's host tables against the JAX package's: the CSR mirror, the
ELL index (buckets, hubs, growth spares, hub merge) and the seeded
graph generator.  Exact equality throughout."""
import numpy as np
import pytest
import torch

from nebula_tpu.cluster import LocalCluster
from nebula_tpu.common.flags import flags as ref_flags
from nebula_tpu.tools import scale_bench
from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tools import graphgen
from nebula_tpu_torch.tpu import csr as tcsr
from nebula_tpu_torch.tpu import ell as tell

MIRROR_FIELDS = tcsr.MIRROR_FIELDS


def _edges(seed=5, n=60, m=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, m)
    dst = rng.integers(1, n + 1, m)
    src[:40] = 3                          # a hub past cap 8
    rank = rng.integers(0, 3, m)
    keep = src != dst
    return src[keep], dst[keep], rank[keep]


@pytest.fixture(scope="module")
def ref_mirror():
    """The JAX cluster's mirror of an edge-only space (edges inserted
    twice in places, with ranks, so KV dedup and rank order matter)."""
    c = LocalCluster(num_storage=1, tpu_backend=True)
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE s(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE s")
        ok("CREATE EDGE e(w int)")
        c.refresh_all()
        src, dst, rank = _edges()
        vals = ", ".join(f"{a} -> {b}@{r}:({(a * 7 + b) % 13})"
                         for a, b, r in zip(src, dst, rank))
        ok(f"INSERT EDGE e(w) VALUES {vals}")
        ok("GO 2 STEPS FROM 1 OVER e")        # builds the mirror
        rt = c.tpu_runtime
        m = rt.mirror(next(iter(rt.mirrors)))
        yield m, src, dst, rank
    finally:
        c.stop()


def test_mirror_from_edges_equals_cluster_mirror(ref_mirror):
    m, src, dst, rank = ref_mirror
    et = int(np.abs(m.edge_etype).max())
    mine = tcsr.mirror_from_edges(src, dst, et, rank=rank)
    assert mine.n == m.n and mine.m == m.m
    for f in MIRROR_FIELDS:
        assert np.array_equal(getattr(mine, f), getattr(m, f)), f
    carried = tcsr.mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=m.space_id)
    for f in MIRROR_FIELDS:
        assert np.array_equal(getattr(carried, f), getattr(m, f)), f


def test_mirror_lookups(ref_mirror):
    m, _src, _dst, _rank = ref_mirror
    mine = tcsr.mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS})
    probe = np.asarray([0, 1, 2, 3, 59, 60, 61, 10 ** 6], np.int64)
    assert np.array_equal(mine.to_dense(probe), m.to_dense(probe))
    for v in probe.tolist():
        assert mine.has_vid(v) == m.has_vid(v)
        assert mine.vid_rank(v) == m.vid_rank(v)


def test_mirror_from_edges_dedups_and_rejects_bad_input():
    m = tcsr.mirror_from_edges([1, 1, 2], [2, 2, 3], 4)
    assert m.m == 4                        # 1->2 once, 2->3, both dirs
    assert np.array_equal(m.vids, [1, 2, 3])
    assert np.array_equal(m.row_ptr, [0, 1, 3, 4])
    with pytest.raises(ValueError):
        tcsr.mirror_from_edges([1], [2, 3], 1)
    with pytest.raises(ValueError):
        tcsr.mirror_from_edges([1], [2], -1)


@pytest.mark.parametrize("cap,slack", [(8, 8), (8, 0), (32, 8), (512, 8)])
def test_ell_build_equals_reference(ref_mirror, cap, slack):
    m = ref_mirror[0]
    jix = jell.EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype, m.n,
                              cap=cap, use_native=False,
                              growth_slack=slack)
    tix = tell.EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype, m.n,
                              cap=cap, growth_slack=slack)
    for f in ("n", "m", "n_rows", "bucket_D"):
        assert getattr(tix, f) == getattr(jix, f), f
    for f in ("perm", "inv", "extra_owner"):
        assert np.array_equal(getattr(tix, f), getattr(jix, f)), f
    for a, b in zip(tix.bucket_nbr + tix.bucket_et,
                    jix.bucket_nbr + jix.bucket_et):
        assert a.shape == b.shape and np.array_equal(a, b)
    for a, b in zip(tix.hub_merge(), jix.hub_merge()):
        assert np.array_equal(a, b)
    assert tix.shape_sig() == jix.shape_sig()
    assert tix.n_hubs == jix.n_hubs
    assert tix.spare_sentinel() == jix.spare_sentinel()
    assert (tix.extra_owner == tix.n_rows).sum() == slack
    if cap == 8:
        assert len(tix.extra_owner) > slack     # real hub rows exist
    carried = tell.ell_from_reference(
        {f: getattr(jix, f) for f in tell.ELL_FIELDS})
    assert carried.shape_sig() == jix.shape_sig()


def test_device_tables_lay_out_every_bucket(ref_mirror):
    m = ref_mirror[0]
    tix = tell.EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype, m.n,
                              cap=8, growth_slack=8)
    t = tix.device_tables(torch.device("cpu"))
    assert t.n == tix.n and t.n_rows == tix.n_rows
    assert sum(t.rows) == tix.n_rows
    for b, (nbr, et) in enumerate(zip(tix.bucket_nbr, tix.bucket_et)):
        tn, te = t.bucket(b)
        assert np.array_equal(tn.numpy(), nbr)
        assert np.array_equal(te.numpy(), et)


def test_lane_packing_and_traffic_model(ref_mirror):
    rng = np.random.default_rng(0)
    f = rng.random((37, 128)) < 0.3
    for B in (8, 128, 1024):
        assert tell.lanes_width(B) == jell.lanes_width(B)
    p = tell.pack_lanes_host(f)
    assert np.array_equal(p, jell.pack_lanes_host(f))
    assert np.array_equal(tell.unpack_lanes_host(p, 128), f)
    # bit k of word j is lane 8j + k
    one = np.zeros((1, 128), bool)
    one[0, 8 * 3 + 5] = True
    assert tell.pack_lanes_host(one)[0, 3] == 1 << 5
    m = ref_mirror[0]
    jix = jell.EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype, m.n,
                              cap=8, use_native=False, growth_slack=8)
    tix = tell.ell_from_reference({f: getattr(jix, f)
                                   for f in tell.ELL_FIELDS})
    for W, steps in ((16, 2), (128, 4)):
        assert tell.dense_hop_bytes(tix, W, steps) == \
            jell.dense_hop_bytes(jix, W, steps)


@pytest.mark.parametrize("seed", [0, 11])
def test_powerlaw_graph_equals_scale_bench(seed):
    for n, m in ((5000, 40000), (3000, 1000)):   # top-up and trim paths
        a = graphgen.powerlaw_graph(n, m, 2.2, 2000, seed)
        b = scale_bench.powerlaw_graph(n, m, 2.2, 2000, seed)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_flag_defaults_match_reference():
    from nebula_tpu_torch.common.flags import flags
    import nebula_tpu.tpu.runtime  # noqa: F401 — defines the flags
    for name in ("go_batch_widths", "tpu_ell_cap", "tpu_ell_growth_slack"):
        assert flags.info(name).default == ref_flags.info(name).default

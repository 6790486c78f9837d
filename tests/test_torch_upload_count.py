"""The packed start upload and the COUNT(*) fold of the windowed route
(nebula_tpu_torch/tpu/ell_ops.py ``frontier_upload`` and ``go_count``,
and the runtime's ``_upload_frontier_packed``) against the JAX
functions they replace: ``TpuQueryRuntime._upload_frontier_packed``
(runtime.py:3251) and the count form of ``make_batched_go_lanes_kernel``
(ell.py:572, ``deg @ bits`` at :616).

The same seeded numpy inputs go through the JAX function on CPU jax and
the port on CPU torch (the wrappers' plain route).  Frontiers and int32
counts are compared for exact equality over every one of the
``n_rows + 1`` rows.  The ELL tables are the JAX package's own numpy
build at cap 8 with growth slack 8, carried into the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu.runtime import TpuQueryRuntime
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import ELL_FIELDS, ell_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def ells():
    """A 300-vertex graph with hubs past cap 8, both directions."""
    rng = np.random.default_rng(5)
    n, m = 300, 1400
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:60] = 5
    et = rng.integers(1, 3, m)
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    jix = jell.EllIndex.build(es, ed, ee, n, cap=8, use_native=False,
                              growth_slack=8)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    es_, hr = jix.hub_merge()
    port = dict(tables=tix.device_tables(CPU), eslot=_t(es_), hrows=_t(hr))
    ref = (jnp.asarray(es_), jnp.asarray(hr), *jix.kernel_args()[1:])
    return jix, tix, port, ref


@pytest.fixture(scope="module")
def rt():
    return TorchQueryRuntime(device="cpu")


# ==================================================== the upload
def _coords(rng, tix, B, case):
    """Flat (new-id row, query col) start coordinates of one case."""
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    nq = min(B, 64)
    rows = tix.perm[rng.integers(0, tix.n, 3 * nq)]
    cols = rng.integers(0, B, 3 * nq)
    if case == "duplicates":
        rows = np.concatenate([rows, rows[:9], rows[:4]])
        cols = np.concatenate([cols, cols[:9], cols[:4]])
    elif case == "last_row":         # every lane of the last real row
        rows = np.concatenate([rows, np.full(B, tix.n_rows - 1)])
        cols = np.concatenate([cols, np.arange(B)])
    elif case == "long":             # 90 % of every real row's lanes
        keep = rng.random(tix.n_rows * B) < 0.9
        rows = np.repeat(np.arange(tix.n_rows), B)[keep]
        cols = np.tile(np.arange(B), tix.n_rows)[keep]
    return rows.astype(np.int32), cols.astype(np.int32)


@pytest.mark.parametrize("B", [32, 128, 1024])
@pytest.mark.parametrize("case", ["pairs", "duplicates", "empty",
                                  "last_row", "long"])
def test_upload_frontier_packed_matches_jax(ells, rt, B, case):
    jix, tix, _port, _ref = ells
    rng = np.random.default_rng(B + len(case))
    rows, cols = _coords(rng, tix, B, case)
    if case == "long":           # more entries than a block's 8 KB range
        assert len(rows) > 8192
    want = np.asarray(TpuQueryRuntime._upload_frontier_packed(
        jix, rows, cols, B))
    got = rt._upload_frontier_packed(tix, rows, cols, B)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert np.array_equal(want, got.numpy())
    assert not got[-1].any()
    if case == "last_row":
        assert got[-2].numpy().tolist() == [255] * (B // 8)


@pytest.mark.parametrize("B", [32, 128, 1024])
def test_frontier_upload_plain_sets_each_lane_once(B):
    """The plain version on sorted coordinates with repeats, entries at
    the pad row and beyond: each listed lane of a real row set, nothing
    else, the pad row zero."""
    rng = np.random.default_rng(B)
    R1, W = 97, B // 8
    rows = np.concatenate([rng.integers(0, R1 + 3, 400), [R1 - 1, R1]])
    lanes = np.concatenate([rng.integers(0, B, 400), [0, B - 1]])
    key = np.sort(rows.astype(np.int64) * B + lanes)
    coords = np.stack(np.divmod(key, B)).astype(np.int32)
    out = torch.full((R1, W), 0x5A, dtype=torch.uint8)
    ell_ops.frontier_upload(out, _t(coords))
    want = np.zeros((R1, B), np.uint8)
    real = coords[0] < R1 - 1
    want[coords[0][real], coords[1][real]] = 1
    assert np.array_equal(np.packbits(want, axis=1, bitorder="little"),
                          out.numpy())


def test_up_async_on_the_cpu_gives_the_array(rt):
    a = np.arange(12, dtype=np.int32).reshape(2, 6)
    t = rt._up_async(a)
    assert t.device == CPU and t.dtype == torch.int32
    assert np.array_equal(t.numpy(), a)


def test_frontier_upload_rejects_bad_coords():
    f = torch.zeros((9, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):      # [2, S], not [S]
        ell_ops.frontier_upload(f, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):      # two rows: rows, lanes
        ell_ops.frontier_upload(f, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):      # one tensor, contiguous
        ell_ops.frontier_upload(f, torch.zeros((8, 2),
                                               dtype=torch.int32).t())


@pytest.mark.parametrize("coords", [[[3, 2], [0, 0]], [[2, 2], [5, 4]]])
def test_frontier_upload_rejects_coords_out_of_order(coords):
    """The kernel's searches assume (row, lane) order; the plain version,
    which every CPU caller runs, refuses any other."""
    f = torch.zeros((9, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sorted"):
        ell_ops.frontier_upload(f, torch.tensor(coords, dtype=torch.int32))


# ===================================================== the count
def _frontier(rng, R1, W, kind):
    if kind == "ones":
        f = np.full((R1, W), 255, np.uint8)
    elif kind == "one_bit":
        f = np.zeros((R1, W), np.uint8)
        f[R1 // 3, W - 1] = 0x80
    elif kind == "quarter":          # every word mixed, a bit in four
        f = (rng.integers(0, 256, (R1, W), dtype=np.uint8)
             & rng.integers(0, 256, (R1, W), dtype=np.uint8))
    else:
        f = (rng.integers(0, 256, (R1, W), dtype=np.uint8)
             * (rng.random((R1, 1)) < 0.5)).astype(np.uint8)
    return f


def _deg(rng, tix, kind):
    if kind == "wrap":               # large enough that the sums wrap
        deg = rng.integers(2**30, 2**31 - 1, tix.n_rows + 1)
    else:
        deg = rng.integers(0, 70000, tix.n_rows + 1)
    deg[tix.n:] = 0                  # extras and the pad row count 0
    return deg.astype(np.int32)


@pytest.mark.parametrize("B", [32, 128, 1024])
@pytest.mark.parametrize("frontier", ["ones", "one_bit", "random",
                                      "quarter"])
@pytest.mark.parametrize("deg_kind", ["small", "wrap"])
def test_go_count_matches_jax(ells, B, frontier, deg_kind):
    jix, tix, port, ref = ells
    rng = np.random.default_rng(B + len(frontier) + len(deg_kind))
    R1, W = tix.n_rows + 1, B // 8
    f0 = _frontier(rng, R1, W, frontier)
    deg = _deg(rng, tix, deg_kind)
    kern = jell.make_batched_go_lanes_kernel(jix, 1, (1,), count=True,
                                             donate=False)
    want = np.asarray(kern(jnp.asarray(f0), ref[0], ref[1],
                           jnp.asarray(deg), *ref[2:]))
    counts = torch.full((B,), 7, dtype=torch.int32)
    got = ell_ops.go_count(_t(f0), _t(deg), counts)
    assert got is counts
    assert np.array_equal(want, got.numpy())
    whole = ell_ops.ell_go_count(_t(f0), _t(deg), over=(1,), steps=1,
                                 **port)
    assert np.array_equal(want, whole.numpy())
    wide = (deg.astype(np.int64)[:, None]
            * np.unpackbits(f0, axis=1, bitorder="little")).sum(0)
    assert np.array_equal(want, wide.astype(np.uint32).view(np.int32))
    if deg_kind == "wrap" and frontier == "ones":
        assert (wide > 2**31 - 1).all()    # every lane wrapped


def test_count_state_is_zero_and_kept_per_device():
    t = ell_ops.count_state(CPU)
    assert t.dtype == torch.int32 and t.shape == (ell_ops.COUNT_STATE_WORDS,)
    assert not t.any()
    assert ell_ops.count_state(torch.device("cpu")) is t

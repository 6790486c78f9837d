"""The port's four lane kernels (nebula_tpu_torch/tpu/ell_ops.py) against
the JAX kernel factories they replace (nebula_tpu/tpu/ell.py:665-743).

The same seeded numpy inputs go through the JAX function on CPU jax
(``donate=False``) and through the port's wrapper on CPU torch, which
takes the plain PyTorch route for a CPU tensor.  Frontiers are bitsets,
so every comparison is exact equality.  Tables come from the JAX
package's own numpy build (cap 8, growth slack 8: hubs and unclaimed
growth spares are present) carried into the port, so both sides
compute on identical state.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import _build, ell_ops
from nebula_tpu_torch.tpu.device import resolve_device
from nebula_tpu_torch.tpu.ell import ELL_FIELDS, ell_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

CPU = torch.device("cpu")
OVER_SETS = [(1,), (-1,), (-1, 1, 2)]


def _graph(seed=3, n=400, m=3000):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2)
    with two hubs well past cap 8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:120] = 7                       # hub by out-degree
    dst[120:200] = 11                   # hub by in-degree
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
    assert len(jix.extra_owner) > 8      # hubs beyond the spares
    assert (jix.extra_owner == jix.n_rows).sum() == 8   # unclaimed spares
    return jix, tix


def _frontier(rng, R1, W, density=0.08):
    f = rng.integers(0, 256, (R1, W), dtype=np.uint8)
    f &= (rng.random((R1, 1)) < density).astype(np.uint8) * 255
    f[-1] = 0                            # the pad row is always zero
    return f


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.mark.parametrize("B", [128, 1024])
@pytest.mark.parametrize("over", OVER_SETS)
def test_go_hop_matches_jax_over_several_hops(ells, B, over):
    jix, tix = ells
    W = B // 8
    rng = np.random.default_rng(B + len(over))
    fp = _frontier(rng, tix.n_rows + 1, W)
    accp = fp | _frontier(rng, tix.n_rows + 1, W, 0.05)
    es, hr = jix.hub_merge()
    hop = jell.make_continuous_hop_kernel(jix, over, donate=False)
    tables = tix.device_tables(CPU)
    te, th = (_t(a) for a in tix.hub_merge())
    jf, ja = jnp.asarray(fp), jnp.asarray(accp)
    tf, ta, spare = _t(fp), _t(accp), torch.empty(fp.shape, dtype=torch.uint8)
    for _ in range(4):
        jf, ja = hop(jf, ja, jnp.asarray(es), jnp.asarray(hr),
                     *jix.kernel_args()[1:])
        out, _ = ell_ops.go_hop(tf, ta, spare, tables, te, th, over)
        spare, tf = tf, out
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(ja), ta.numpy())
    assert tf.numpy().any()              # the hops moved something


@pytest.mark.parametrize("B", [128, 1024])
def test_lane_join_matches_jax(ells, B):
    jix, tix = ells
    W = B // 8
    rng = np.random.default_rng(B)
    fp = _frontier(rng, tix.n_rows + 1, W)
    accp = fp | _frontier(rng, tix.n_rows + 1, W)
    lanes = rng.choice(B, 6, replace=False)
    keep = np.full(W, 0xFF, np.uint8)
    for ln in lanes:
        keep[ln >> 3] &= np.uint8(0xFF ^ (1 << (ln & 7)))
    fp &= keep                           # joiners land on cleared lanes
    accp &= keep
    rows, words, vals = [], [], []
    for ln in lanes:
        r = rng.choice(tix.n, 5, replace=False)
        rows += tix.perm[r].tolist()
        words += [ln >> 3] * 5
        vals += [1 << (ln & 7)] * 5
    S = len(rows)
    Sp = 1 << (S - 1).bit_length()
    rows_p = np.full(Sp, tix.n_rows, np.int32)
    words_p = np.zeros(Sp, np.int32)
    vals_p = np.zeros(Sp, np.uint8)
    rows_p[:S], words_p[:S], vals_p[:S] = rows, words, vals
    join = jell.make_lane_join_kernel(jix, donate=False)
    jf, ja = join(jnp.asarray(fp), jnp.asarray(accp), rows_p, words_p,
                  vals_p)
    tf, ta = _t(fp), _t(accp)
    ell_ops.lane_join(tf, ta, _t(rows_p), _t(words_p), _t(vals_p))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert not np.array_equal(fp, tf.numpy())


@pytest.mark.parametrize("B", [128, 1024])
def test_lane_extract_matches_jax(ells, B):
    jix, tix = ells
    W = B // 8
    rng = np.random.default_rng(B + 1)
    fp = _frontier(rng, tix.n_rows + 1, W)
    accp = fp | _frontier(rng, tix.n_rows + 1, W)
    P = 8
    words = rng.choice(W, P, replace=False).astype(np.int32)
    sel = (rng.random(P) < 0.5).astype(np.uint8)
    sel[0], sel[1] = 0, 1
    want = jell.make_lane_extract_kernel()(jnp.asarray(fp),
                                           jnp.asarray(accp), words, sel)
    out = torch.empty((tix.n_rows + 1, P), dtype=torch.uint8)
    ell_ops.lane_extract(_t(fp), _t(accp), _t(words), _t(sel), out)
    assert np.array_equal(np.asarray(want), out.numpy())


@pytest.mark.parametrize("B", [128, 1024])
def test_lane_clear_matches_jax(ells, B):
    jix, tix = ells
    W = B // 8
    rng = np.random.default_rng(B + 2)
    fp = _frontier(rng, tix.n_rows + 1, W, 0.5)
    accp = fp | _frontier(rng, tix.n_rows + 1, W, 0.5)
    keep = rng.integers(0, 256, W, dtype=np.uint8)
    jf, ja = jell.make_lane_clear_kernel(donate=False)(
        jnp.asarray(fp), jnp.asarray(accp), keep)
    tf, ta = _t(fp), _t(accp)
    ell_ops.lane_clear(tf, ta, _t(keep))
    assert np.array_equal(np.asarray(jf), tf.numpy())
    assert np.array_equal(np.asarray(ja), ta.numpy())


def test_wrappers_reject_bad_operands(ells):
    _, tix = ells
    R1 = tix.n_rows + 1
    fp = torch.zeros((R1, 16), dtype=torch.uint8)
    acc = torch.zeros_like(fp)
    with pytest.raises(ValueError):      # W not a multiple of 4
        ell_ops.lane_clear(fp[:, :6].contiguous(), acc[:, :6].contiguous(),
                           torch.zeros(6, dtype=torch.uint8))
    with pytest.raises(TypeError):       # wrong dtype
        ell_ops.lane_clear(fp, acc, torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError):      # wrong shape
        ell_ops.lane_clear(fp, acc, torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError):      # non-contiguous
        ell_ops.lane_clear(fp.t().contiguous().t(), acc,
                           torch.zeros(16, dtype=torch.uint8))
    tables = tix.device_tables(CPU)
    te, th = (_t(a) for a in tix.hub_merge())
    with pytest.raises(ValueError):      # hop output aliasing its input
        ell_ops.go_hop(fp, acc, fp, tables, te, th, (1,))
    meta = torch.empty((R1, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):      # no route for this device
        ell_ops.lane_clear(meta, torch.empty_like(meta),
                           torch.empty(16, dtype=torch.uint8, device="meta"))


def test_cuda_requests_raise_without_a_card(monkeypatch):
    """No CUDA here: asking for the card raises, it never runs on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        TorchQueryRuntime()
    assert resolve_device("cpu") == CPU


def test_kernel_route_never_falls_back(ells, monkeypatch):
    """A wrapper on the kernel route whose library cannot load raises
    and leaves the carriers untouched — the plain version is not run."""
    _, tix = ells
    fp = torch.full((tix.n_rows + 1, 16), 0xFF, dtype=torch.uint8)
    acc = fp.clone()

    def no_lib():
        raise RuntimeError("kernel library unavailable")
    monkeypatch.setattr(ell_ops, "_route", lambda dev: True)
    monkeypatch.setattr(ell_ops, "_lib", no_lib)
    before = dict(ell_ops.LAUNCHES)
    with pytest.raises(RuntimeError):
        ell_ops.lane_clear(fp, acc, torch.zeros(16, dtype=torch.uint8))
    assert bool((fp == 0xFF).all()) and bool((acc == 0xFF).all())
    assert ell_ops.LAUNCHES == before


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'ell_lanes.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "LIB_PATH",
                        str(tmp_path / "out" / "libell_lanes.so"))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build(force=True)
    assert not os.path.exists(_build.LIB_PATH)


def test_build_runs_nvcc_only_when_the_library_is_stale(tmp_path,
                                                         monkeypatch):
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = cuda / "nvcc"
    # a stand-in compiler: records each call and writes the -o target
    nvcc.write_text("#!/bin/sh\necho x >> " + str(calls) + "\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then shift; echo lib > \"$1\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "SOURCES", (str(src),))
    monkeypatch.setattr(_build, "OUT_DIR", str(tmp_path / "out"))
    lib = tmp_path / "out" / "libell_lanes.so"
    monkeypatch.setattr(_build, "LIB_PATH", str(lib))

    def n_calls():
        return len(calls.read_text().splitlines()) if calls.exists() else 0

    assert _build.build() == str(lib) and n_calls() == 1   # missing
    _build.build()
    assert n_calls() == 1                                  # fresh
    later = os.path.getmtime(lib) + 10
    os.utime(src, (later, later))
    _build.build()
    assert n_calls() == 2                                  # source newer
    _build.build(force=True)
    assert n_calls() == 3
    assert not [p for p in os.listdir(tmp_path / "out") if p.endswith(".tmp")]

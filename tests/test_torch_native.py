"""The port's native snapshot builder and ``rgcn_aggregate(impl="cumsum")``.

- ``regcn_torch/data/native.py`` (``regcn_torch/csrc/graph_builder.cc``
  compiled at first use) against the port's numpy builder and against
  ``regcn_tpu``'s ``build_snapshot`` with ``use_native`` both ways: every
  array equal bit for bit, dtypes included, in both ``rc_mode``s, for
  empty, single-triple and random snapshots, at tight and bucketed
  padding. JAX's native module is built as ``tests/test_native.py``
  builds it; where it cannot be, JAX's ``use_native=True`` case compares
  with JAX's numpy path, which its own test holds bit-equal to it.
- A build into a fresh directory, a failing build (it raises with the
  compiler's message) and a module of an older signature (numpy for the
  default, a raise for ``use_native=True``, as in JAX).
- The padded tail both builders emit: real edges first, destination-sorted,
  then zero-filled src / dst / rel with a zero mask. The cumsum route
  relies on it (its segment offsets come from the running max of the raw
  dst).
- ``impl="cumsum"`` against JAX's ``_rgcn_aggregate_cumsum`` (the same
  algorithm: rtol 1e-5, atol 1e-6 of the output's scale) and against the
  port's exact route, B1's plain version (the fp32 running sum is
  approximate: rtol 1e-4, atol 1e-5 of the scale), forward and the
  gradients of h, the relation embeddings and the weight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regcn_tpu import native as jax_native
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.ops.rgcn_scatter import rgcn_aggregate as jax_rgcn_aggregate
from regcn_torch.data import native
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.ops.rgcn_scatter import IMPLS, check_impl, rgcn_aggregate

FIELDS = pt_snapshots._ARRAY_FIELDS

N_ENTS, N_RELS = 50, 6


def triples_of(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "empty":
        return np.zeros((0, 3), np.int64)
    if kind == "single":
        return np.array([[3, 2, 41]], np.int64)
    m = 120
    t = np.stack([rng.integers(0, N_ENTS, m), rng.integers(0, N_RELS, m),
                  rng.integers(0, N_ENTS, m)], axis=1)
    return np.unique(t, axis=0)


def padding(kind: str, n: int) -> dict:
    if kind == "tight":  # the least the native builder takes: 2n edges, 4n pairs
        return dict(edge_pad=2 * n, rc_pad=4 * n)
    return dict(edge_bucket=64, rc_bucket=128)


def assert_same(a, b, what):
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f}")
    assert (a.num_edges, a.num_triples, a.dst_sorted) == (b.num_edges, b.num_triples,
                                                          b.dst_sorted), what


@pytest.fixture(scope="module")
def jax_native_built() -> bool:
    """Whether JAX's native module loads, built as tests/test_native.py
    builds it where it is not."""
    return jax_native.load() is not None or jax_native.ensure_built()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ builder

@pytest.mark.parametrize("kind", ["empty", "single", "random"])
@pytest.mark.parametrize("pad", ["tight", "bucketed"])
@pytest.mark.parametrize("rc_mode", ["both", "src"])
def test_native_builder_matches_numpy_and_jax(kind, pad, rc_mode, jax_native_built):
    triples = triples_of(kind)
    kw = dict(padding(pad, len(triples)), rc_mode=rc_mode)
    got = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, **kw)  # default: native
    assert_same(got, pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=True, **kw),
                "port native (None vs True)")
    jax_native_case = jax_snapshots.build_snapshot(triples, N_ENTS, N_RELS,
                                                   use_native=jax_native_built, **kw)
    assert_same(got, jax_native_case, "port native vs JAX native")
    numpy_kw = dict(kw)
    if pad == "bucketed":  # numpy pads the context to its unique pairs, native to 4n
        numpy_kw["rc_pad"] = got.rc_rel.shape[0]
    want = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=False, **numpy_kw)
    assert_same(got, want, "port native vs port numpy")
    assert_same(want, jax_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=False,
                                                   **numpy_kw), "port numpy vs JAX numpy")


@pytest.mark.parametrize("rc_mode", ["both", "src"])
def test_history_windows_match_numpy(rc_mode):
    """``build_history`` pads the context to 4 x the window's largest
    snapshot, so the two builders agree on every shape there."""
    rng = np.random.default_rng(3)
    snaps = [np.stack([rng.integers(0, N_ENTS, m), rng.integers(0, N_RELS, m),
                       rng.integers(0, N_ENTS, m)], 1) for m in (5, 40, 17)]
    kw = dict(edge_bucket=32, rc_bucket=64, rc_mode=rc_mode)
    assert_same(pt_snapshots.build_history(snaps, N_ENTS, N_RELS, **kw),
                pt_snapshots.build_history(snaps, N_ENTS, N_RELS, use_native=False, **kw),
                "history")


def test_build_in_a_fresh_directory(tmp_path):
    """The compile path itself: a new directory, the hashed library name,
    no temporary file left, and the module it loads builds the numpy
    arrays."""
    path = native.build(tmp_path)
    assert path.exists() and path.parent == tmp_path
    assert path == native.library_path(tmp_path)
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    mod = native.load(tmp_path)
    triples = triples_of("random")
    arrays = mod.build_snapshot_arrays(triples, N_ENTS, N_RELS, 256, 512, 0)
    want = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_pad=256, rc_pad=512,
                                       use_native=False)
    for f, a in zip(FIELDS, arrays[:9]):
        np.testing.assert_array_equal(a, getattr(want, f), err_msg=f)
    assert arrays[9:] == (want.num_edges, want.num_triples)
    assert native.build(tmp_path) == path  # built once


def test_failing_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building the native snapshot builder failed"):
        native.build(tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_default_takes_numpy_on_a_host_without_a_compiler(tmp_path, monkeypatch):
    """ROADMAP C.8: with ``$CXX`` a missing program and a fresh build
    directory, the default builds numpy's arrays (numpy's relation-context
    padding) after one warning for the process, and tries the compiler
    once; ``use_native=True`` raises."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_build_failures", {})
    monkeypatch.setattr(native, "_warned", [False])
    calls = []
    build = native.build
    monkeypatch.setattr(native, "build", lambda *a: calls.append(a) or build(*a))
    triples = triples_of("random")
    kw = dict(edge_bucket=64, rc_bucket=128)
    with pytest.warns(RuntimeWarning, match="cannot be built") as record:
        got = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, **kw)
        hist = pt_snapshots.build_history([triples, triples[:7]], N_ENTS, N_RELS, **kw)
    assert len(record) == 1 and len(calls) == 1
    assert_same(got, pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=False, **kw),
                "numpy fallback")
    assert_same(got, jax_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=False, **kw),
                "JAX's numpy builder")
    assert_same(hist, pt_snapshots.build_history([triples, triples[:7]], N_ENTS, N_RELS,
                                                 use_native=False, **kw), "history")
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, use_native=True, **kw)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_stale_module_falls_back_to_numpy(monkeypatch):
    """JAX's stale-signature check: the default falls back to numpy with a
    warning, ``use_native=True`` raises; any other TypeError propagates."""
    class Stale:
        @staticmethod
        def build_snapshot_arrays(*args):
            raise TypeError("function takes exactly 5 arguments (6 given)")

    class Broken:
        @staticmethod
        def build_snapshot_arrays(*args):
            raise TypeError("argument 1 must be numpy.ndarray")

    triples = triples_of("random")
    want = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_bucket=64,
                                       use_native=False)
    monkeypatch.setattr(native, "_module", Stale())
    assert_same(pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_bucket=64), want,
                "stale fallback")
    with pytest.raises(native.StaleNativeError, match="stale"):
        pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_bucket=64, use_native=True)
    monkeypatch.setattr(native, "_module", Broken())
    with pytest.raises(TypeError, match="must be numpy.ndarray"):
        pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_bucket=64)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("rc_mode", ["both", "src"])
def test_builders_emit_the_zero_filled_tail_cumsum_needs(use_native, rc_mode):
    """Real edges first with dst ascending and mask 1, then the padded
    tail: src, dst and rel 0, mask 0; the relation context likewise."""
    triples = triples_of("random")
    snap = pt_snapshots.build_snapshot(triples, N_ENTS, N_RELS, edge_bucket=64,
                                       use_native=use_native, rc_mode=rc_mode)
    e = snap.num_edges
    assert e == 2 * len(triples) and len(snap.src) > e and snap.dst_sorted
    np.testing.assert_array_equal(snap.edge_mask, (np.arange(len(snap.src)) < e).astype(np.float32))
    assert np.all(np.diff(snap.dst[:e]) >= 0)
    for f in ("src", "dst", "rel"):
        assert not getattr(snap, f)[e:].any(), f
    m = int(snap.rc_mask.sum())
    assert snap.rc_mask[:m].all() and not snap.rc_mask[m:].any()
    assert not snap.rc_rel[m:].any() and not snap.rc_ent[m:].any()
    # so the running max of the raw dst is the real edges' last key over the tail
    run = np.maximum.accumulate(snap.dst)
    assert np.all(run[e:] == snap.dst[e - 1])


# ------------------------------------------------------------------- cumsum

def test_cumsum_is_a_route():
    assert "cumsum" in IMPLS
    check_impl("cumsum")
    with pytest.raises(ValueError, match="destination-sorted"):
        z = torch.zeros(2, dtype=torch.long)
        rgcn_aggregate(torch.zeros(3, 4), torch.zeros(2, 4), torch.zeros(4, 4), z, z, z,
                       torch.ones(2), torch.ones(3), dst_sorted=False, impl="cumsum")


def aggregate_inputs(seed: int, d: int = 8):
    rng = np.random.default_rng(seed)
    snap = pt_snapshots.build_snapshot(triples_of("random"), N_ENTS, N_RELS, edge_bucket=64)
    h = rng.normal(size=(N_ENTS, d)).astype(np.float32)
    rel = rng.normal(size=(2 * N_RELS, d)).astype(np.float32)
    w = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32)
    g = rng.normal(size=(N_ENTS, d)).astype(np.float32)
    return snap, h, rel, w, g


def port_aggregate(snap, h, rel, w, g, impl):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (h, rel, w)]
    ts = snap.to("cpu")
    out = rgcn_aggregate(*t, ts.src, ts.dst, ts.rel, ts.edge_mask, ts.in_deg_norm,
                         dst_sorted=True, impl=impl)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), t)
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("seed", [0, 1])
def test_cumsum_matches_jax_and_the_exact_route(seed):
    snap, h, rel, w, g = aggregate_inputs(seed)
    got, got_grads = port_aggregate(snap, h, rel, w, g, "cumsum")

    def jax_fn(h_, rel_, w_):
        out = jax_rgcn_aggregate(h_, rel_, w_, jnp.asarray(snap.src), jnp.asarray(snap.dst),
                                 jnp.asarray(snap.rel), jnp.asarray(snap.edge_mask),
                                 jnp.asarray(snap.in_deg_norm), impl="cumsum", dst_sorted=True)
        return jnp.sum(out * g), out

    jgrads, jout = jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(h, rel, w)
    scale = np.abs(np.asarray(jout)).max()
    np.testing.assert_allclose(got, np.asarray(jout), rtol=1e-5, atol=1e-6 * scale)
    for name, a, b in zip(("h", "rel", "w"), got_grads, jgrads):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * np.abs(b).max(), err_msg=name)
    exact, exact_grads = port_aggregate(snap, h, rel, w, g, "xla")
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-5 * scale)
    for name, a, b in zip(("h", "rel", "w"), got_grads, exact_grads):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_cumsum_keeps_the_compute_dtype():
    """Under bf16 compute the route returns bf16, as JAX's does."""
    snap, h, rel, w, _ = aggregate_inputs(2)
    ts = snap.to("cpu")
    bf = [torch.from_numpy(a).bfloat16() for a in (h, rel, w)]
    out = rgcn_aggregate(*bf, ts.src, ts.dst, ts.rel, ts.edge_mask.bfloat16(),
                         ts.in_deg_norm.bfloat16(), dst_sorted=True, impl="cumsum")
    want = jax_rgcn_aggregate(*(jnp.asarray(a, jnp.bfloat16) for a in (h, rel, w)),
                              jnp.asarray(snap.src), jnp.asarray(snap.dst),
                              jnp.asarray(snap.rel), jnp.asarray(snap.edge_mask, jnp.bfloat16),
                              jnp.asarray(snap.in_deg_norm, jnp.bfloat16), impl="cumsum",
                              dst_sorted=True)
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)
    # one bf16 rounding of the same fp32 value: at most one ulp (2^-8 relative)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(want).max())

"""The scatter kernel's wrapper, and the kernel against its plain version.

This file imports no JAX, so its CUDA tests also run on a GPU machine
without it (``--noconftest`` skips the JAX set-up in conftest.py):

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels.py

Tolerance on the card: fp32 on both sides, the summation order is the
only difference, so max|kernel - plain| <= 1e-5 * max(1, max|plain|);
gradients on the card against the CPU's, from the same inputs, within
1e-5 * max(1, max|cpu gradient|) (GEMMs and gathers summed in another
order; TF32 off).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from regcn_torch.ops.rgcn_scatter import (
    rgcn_aggregate,
    scatter_add_sorted,
    scatter_add_sorted_reference,
)

KERNEL_TOL = 1e-5
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sorted_keys(rng, E, n, n_real, zipf=None):
    """Ascending keys: n_real real destinations, then a masked tail keyed n."""
    keys = np.full(E, n, np.int32)
    dst = rng.zipf(zipf, n_real) % n if zipf else rng.integers(0, n, n_real)
    keys[:n_real] = np.sort(dst)
    return keys


def test_wrapper_on_cpu_is_the_plain_version(rng):
    E, n, d = 64, 30, 5
    keys = torch.from_numpy(sorted_keys(rng, E, n, 50))
    msg = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32))
    w = torch.from_numpy(rng.random(E).astype(np.float32))
    scale = torch.from_numpy(rng.random(n).astype(np.float32))
    before = scatter_add_sorted.launches
    got = scatter_add_sorted(msg, keys, n, edge_weight=w, row_scale=scale)
    assert scatter_add_sorted.launches == before  # no kernel ran
    assert torch.equal(got, scatter_add_sorted_reference(msg, keys, n, w, scale))
    want = torch.zeros(n, d).index_add_(0, keys[:50].long(), msg[:50] * w[:50, None])
    torch.testing.assert_close(got, want * scale[:, None], rtol=1e-6, atol=1e-6)
    empty = scatter_add_sorted(msg, torch.full((E,), n, dtype=torch.int32), n)
    assert torch.equal(empty, torch.zeros(n, d))


@pytest.mark.parametrize("bad", ["int64_keys", "short_keys", "f64_msg", "strided_msg",
                                 "short_scale", "int_weight", "meta_device"])
def test_wrapper_rejects_bad_inputs(bad):
    E, n, d = 16, 10, 4
    msg = torch.zeros(E, d)
    keys = torch.zeros(E, dtype=torch.int32)
    kw = {}
    if bad == "int64_keys":
        keys = keys.long()
    elif bad == "short_keys":
        keys = keys[:-1]
    elif bad == "f64_msg":
        msg = msg.double()
    elif bad == "strided_msg":
        msg = torch.zeros(E, 2 * d)[:, ::2]
    elif bad == "short_scale":
        kw["row_scale"] = torch.ones(n - 1)
    elif bad == "int_weight":
        kw["edge_weight"] = torch.ones(E, dtype=torch.int32)
    else:  # neither cuda nor cpu: no path at all
        msg, keys = msg.to("meta"), keys.to("meta")
    with pytest.raises(ValueError):
        scatter_add_sorted(msg, keys, n, **kw)


def runs(n, lengths, E=None):
    """Ascending keys: row i of ``lengths`` gets lengths[i] edges, on rows
    spread over [0, n); then a masked tail keyed n up to E slots."""
    rows = np.linspace(0, n - 1, len(lengths)).astype(np.int64)
    keys = np.repeat(rows, lengths).astype(np.int32)
    E = len(keys) if E is None else E
    return np.concatenate([keys, np.full(E - len(keys), n, np.int32)])


# The kernel cuts the edge slots into chunks of 32 (CHUNK); a row whose
# edges cross a chunk boundary is summed in parts and merged by the chunk
# that finishes last.
CHUNK = 32


def kernel_case(case, rng):
    """(n, d, keys, weighted) of each parametrised case."""
    shapes = {
        "config1": (7128, 200, 640, 548, 1.4), "skewed": (7128, 200, 4096, 4096, 1.3),
        "fully_masked": (7128, 200, 640, 0, None), "unweighted": (7128, 200, 512, 500, None),
        "odd_width": (301, 7, 300, 290, 1.4), "wide": (301, 2100, 300, 290, 1.4),
        "wide_odd": (301, 2102, 300, 290, 1.4), "misaligned": (301, 200, 300, 290, 1.4),
        "icews18_shape": (23033, 200, 2314, 2314, 1.3),
    }
    if case in shapes:
        n, d, E, n_real, zipf = shapes[case]
        return n, d, sorted_keys(rng, E, n, n_real, zipf), case != "unweighted"
    n, d = 7128, 200
    keys = {
        # rows one edge short of a chunk, filling one and one edge over, at
        # the alignments the sequence gives, among rows of 1 to 9 edges
        "row_sizes_at_thresholds": runs(n, [8, 9, 1, CHUNK - 1, CHUNK, CHUNK + 1, 3, CHUNK,
                                            CHUNK + 1, 2], E=200),
        # a row of 3 chunks and more that starts in the middle of chunk 0
        "row_over_three_chunks_from_mid_chunk": runs(n, [1] * 10 + [3 * CHUNK + 7, 2, 5], E=160),
        "every_edge_on_one_row": runs(n, [500], E=640),
        "one_real_edge": runs(n, [1], E=640),
        # E = 1000 slots, all real: the last chunk is partial, with no masked tail
        "edges_not_a_multiple_of_the_chunk": sorted_keys(rng, 1000, n, 1000, 1.3),
    }[case]
    return n, d, keys, True


def test_diagnosis_role_builds_cut_the_kernel_source():
    """tools/scatter_diagnosis.py times each kind of block alone by editing
    the kernel's dispatch: each edit still finds its place in the source."""
    sys.path.insert(0, str(ROOT / "tools"))
    import scatter_diagnosis

    src = (ROOT / "regcn_torch" / "csrc" / "rgcn_scatter.cu").read_text()
    builds = scatter_diagnosis.role_builds(src)
    assert "{\n    return;\n    row_block" in builds["chunks only"]
    assert "{\n    return;\n    chunk_block" in builds["rows only"]
    assert all(b.count("return;\n    ") == src.count("return;\n    ") + 1 for b in builds.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "config1", "skewed", "fully_masked", "unweighted", "odd_width", "wide", "wide_odd",
    "misaligned", "row_sizes_at_thresholds", "row_over_three_chunks_from_mid_chunk",
    "every_edge_on_one_row", "one_real_edge", "edges_not_a_multiple_of_the_chunk",
    "icews18_shape"])
def test_kernel_matches_plain_version(rng, cuda, case):
    """config-1 shapes, the kernel's other paths (scalar columns for an odd
    width or a msg not 16-byte aligned, rows wider than one pass), and the
    edge-chunk structure: rows at the chunk size, a row merged from several
    chunks, skew to the limit, a partial last chunk, the ICEWS18 shape."""
    n, d, keys, weighted = kernel_case(case, rng)
    E = len(keys)
    keys = torch.from_numpy(keys).to(cuda)
    msg = torch.from_numpy(rng.normal(size=(E * d + 1,)).astype(np.float32)).to(cuda)
    msg = msg[1:].view(E, d) if case == "misaligned" else msg[:-1].view(E, d)
    kw = {}
    if weighted:
        kw = dict(edge_weight=torch.from_numpy((rng.random(E) < 0.9).astype(np.float32)).to(cuda),
                  row_scale=torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda))
    before = scatter_add_sorted.launches
    got = scatter_add_sorted(msg, keys, n, **kw)
    assert scatter_add_sorted.launches == before + 1
    want = scatter_add_sorted_reference(msg, keys, n, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= KERNEL_TOL * max(1.0, want.abs().max().item())
    if case == "fully_masked":
        assert torch.count_nonzero(got).item() == 0


@pytest.mark.cuda
def test_kernel_is_bitwise_deterministic(rng, cuda):
    """Two calls on the same inputs give the same bits, also with another
    call between them (the per-row counters are back at zero after each)."""
    n, d, E = 7128, 200, 2048
    keys = torch.from_numpy(sorted_keys(rng, E, n, 1900, 1.3)).to(cuda)
    msg = torch.from_numpy(rng.normal(size=(E, d)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.random(E).astype(np.float32)).to(cuda)
    scale = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    first = scatter_add_sorted(msg, keys, n, edge_weight=w, row_scale=scale)
    second = scatter_add_sorted(msg, keys, n, edge_weight=w, row_scale=scale)
    other = torch.from_numpy(runs(n, [3 * CHUNK + 7, 5], E=200)).to(cuda)
    scatter_add_sorted(msg[:200], other, n)
    third = scatter_add_sorted(msg, keys, n, edge_weight=w, row_scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)


@pytest.mark.cuda
def test_unsorted_edges_through_rgcn_aggregate(rng, cuda):
    """A hand-built edge order (dst_sorted=False) is sorted before the kernel."""
    n, R, d, E = 7128, 230, 200, 640
    dst = rng.integers(0, n, E)
    mask = (np.arange(E) < 520).astype(np.float32)
    dst[520:] = 0  # a padded tail, then the whole edge list shuffled
    order = rng.permutation(E)
    src = torch.from_numpy(rng.integers(0, n, E)[order]).to(cuda)
    rel = torch.from_numpy(rng.integers(0, 2 * R, E)[order]).to(cuda)
    dst, mask = torch.from_numpy(dst[order]).to(cuda), torch.from_numpy(mask[order]).to(cuda)
    h = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    rel_emb = torch.from_numpy(rng.normal(size=(2 * R, d)).astype(np.float32)).to(cuda)
    weight = torch.from_numpy((rng.normal(size=(d, d)) / d ** 0.5).astype(np.float32)).to(cuda)
    norm = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    got = rgcn_aggregate(h, rel_emb, weight, src, dst, rel, mask, norm, dst_sorted=False)
    keys = torch.where(mask > 0, dst, n).to(torch.int32)
    want = scatter_add_sorted_reference((h[src] + rel_emb[rel]) @ weight, keys, n, mask, norm)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= KERNEL_TOL * max(1.0, want.abs().max().item())


def aggregate_case(rng, dst_sorted):
    """Config-1 shapes: 520 real edges sorted by dst, a padded tail with
    dst = 0 and weight 0, real weights in (0, 1]; shuffled when not sorted."""
    n, R, d, E, real = 7128, 230, 200, 640, 520
    dst = np.concatenate([np.sort(rng.integers(0, n, real)), np.zeros(E - real, np.int64)])
    w = np.concatenate([rng.uniform(0.1, 1.0, real), np.zeros(E - real)]).astype(np.float32)
    src, rel = rng.integers(0, n, E), rng.integers(0, 2 * R, E)
    if not dst_sorted:
        order = rng.permutation(E)
        src, dst, rel, w = src[order], dst[order], rel[order], w[order]
    return dict(h=rng.normal(size=(n, d)).astype(np.float32),
                rel_emb=rng.normal(size=(2 * R, d)).astype(np.float32),
                weight=(rng.normal(size=(d, d)) / d ** 0.5).astype(np.float32),
                src=src, dst=dst, rel=rel, edge_weight=w,
                norm=rng.random(n).astype(np.float32), G=rng.normal(size=(n, d)).astype(np.float32))


def aggregate_grads(case, device, dst_sorted):
    """Gradients of sum(rgcn_aggregate(...) * G) by h, rel_emb, W and the edge weight."""
    leaves = [torch.from_numpy(case[k]).to(device).requires_grad_(True)
              for k in ("h", "rel_emb", "weight", "edge_weight")]
    src, dst, rel, norm, G = (torch.from_numpy(case[k]).to(device)
                              for k in ("src", "dst", "rel", "norm", "G"))
    out = rgcn_aggregate(*leaves[:3], src, dst, rel, leaves[3], norm, dst_sorted=dst_sorted)
    return torch.autograd.grad(out, leaves, G)


@pytest.mark.cuda
@pytest.mark.parametrize("dst_sorted", [True, False])
def test_rgcn_aggregate_gradients_on_cuda_match_the_cpu(rng, cuda, dst_sorted):
    """The scatter is differentiable on the card: h, rel_emb, W and the edge
    weight get the CPU's gradients, and two backward calls the same bits."""
    case = aggregate_case(rng, dst_sorted)
    before = scatter_add_sorted.launches
    first = aggregate_grads(case, cuda, dst_sorted)
    second = aggregate_grads(case, cuda, dst_sorted)
    assert scatter_add_sorted.launches == before + 2
    want = aggregate_grads(case, "cpu", dst_sorted)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("h", "rel_emb", "W", "edge_weight"), first, second, want):
        assert a is not None and torch.equal(a, b), name
        err = (a.cpu() - w).abs().max().item()
        assert err <= KERNEL_TOL * max(1.0, w.abs().max().item()), (name, err)

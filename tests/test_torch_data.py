"""The port's data layer against regcn_tpu.data: every array exactly equal."""

import numpy as np
import pytest

from regcn_tpu.data import answers as jax_answers
from regcn_tpu.data import dataset as jax_dataset
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.data import synthetic as jax_synthetic
from regcn_torch.data import answers as pt_answers
from regcn_torch.data import dataset as pt_dataset
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data import synthetic as pt_synthetic

TINY = dict(num_ents=64, num_rels=6, num_snaps=10, triples_per_snap=40, split=(6, 2, 2))
ARRAY_FIELDS = ("src", "dst", "rel", "edge_mask", "in_deg_norm", "has_in_edge",
                "rc_rel", "rc_ent", "rc_mask")


def assert_same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def assert_same_snapshot(pt, jx):
    for f in ARRAY_FIELDS:
        assert_same_array(getattr(pt, f), getattr(jx, f))
    assert (pt.num_edges, pt.num_triples, pt.dst_sorted) == (
        jx.num_edges, jx.num_triples, jx.dst_sorted)


@pytest.fixture(scope="module")
def tiny_data():
    return (pt_synthetic.generate("synthetic-small", seed=123, **TINY),
            jax_synthetic.generate("synthetic-small", seed=123, **TINY))


@pytest.mark.parametrize("name,kwargs", [
    ("synthetic-small", TINY),
    ("synthetic-small", dict(TINY, num_rels=3)),
    ("synthetic-icews14s", dict(num_snaps=12, split=(8, 2, 2))),
])
def test_generate_equal(name, kwargs):
    pt = pt_synthetic.generate(name, seed=7, **kwargs)
    jx = jax_synthetic.generate(name, seed=7, **kwargs)
    for split in ("train", "valid", "test"):
        assert_same_array(getattr(pt, split), getattr(jx, split))
    assert (pt.num_nodes, pt.num_rels) == (jx.num_nodes, jx.num_rels)


def test_load_from_local_equal(tmp_path, tiny_data):
    pt, _ = tiny_data
    d = tmp_path / "toy"
    d.mkdir()
    (d / "entity2id.txt").write_text("".join(f"e{i}\t{i}\n" for i in range(pt.num_nodes)))
    (d / "relation2id.txt").write_text("".join(f"r{i}\t{i}\n" for i in range(pt.num_rels)))
    for split in ("train", "valid", "test"):
        rows = getattr(pt, split)
        (d / f"{split}.txt").write_text("".join("\t".join(map(str, r)) + "\n" for r in rows))
    got = pt_dataset.load_data("toy", data_dir=str(tmp_path))
    want = jax_dataset.load_data("toy", data_dir=str(tmp_path))
    for split in ("train", "valid", "test"):
        assert_same_array(getattr(got, split), getattr(want, split))
        assert_same_array(getattr(got, split), getattr(pt, split))
    assert (got.num_nodes, got.num_rels) == (want.num_nodes, want.num_rels)


def test_split_by_time_equal(tiny_data):
    pt, jx = tiny_data
    for split in ("train", "valid", "test"):
        a = pt_snapshots.split_by_time(getattr(pt, split))
        b = jax_snapshots.split_by_time(getattr(jx, split))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert_same_array(x, y)


@pytest.mark.parametrize("pads", [dict(), dict(edge_bucket=16, rc_bucket=32),
                                  dict(edge_pad=200, rc_pad=400)])
def test_build_snapshot_equal(tiny_data, pads):
    """The numpy builders, array for array (the native builder, the port's
    default, is held against both of JAX's in tests/test_torch_native.py)."""
    pt, _ = tiny_data
    for triples in pt_snapshots.split_by_time(pt.train):
        got = pt_snapshots.build_snapshot(triples, pt.num_nodes, pt.num_rels, use_native=False,
                                          **pads)
        want = jax_snapshots.build_snapshot(triples, pt.num_nodes, pt.num_rels,
                                            use_native=False, **pads)
        assert_same_snapshot(got, want)


def test_build_history_and_pad_triples_equal(tiny_data):
    pt, _ = tiny_data
    snaps = pt_snapshots.split_by_time(pt.train)
    for lo in range(len(snaps) - 2):
        window = snaps[lo:lo + 3]
        got = pt_snapshots.build_history(window, pt.num_nodes, pt.num_rels,
                                         edge_bucket=32, rc_bucket=64)
        want = jax_snapshots.build_history(window, pt.num_nodes, pt.num_rels,
                                           edge_bucket=32, rc_bucket=64)
        assert_same_snapshot(got, want)
        for t in range(3):  # one step of the stack is the step's own arrays
            step = got.step(t)
            for f in ARRAY_FIELDS:
                assert_same_array(getattr(step, f), getattr(want, f)[t])
    for triples in snaps:
        for bucket in (16, 128):
            got = pt_snapshots.pad_triples(triples, pt.num_rels, bucket)
            want = jax_snapshots.pad_triples(triples, pt.num_rels, bucket)
            for a, b in zip(got, want):
                assert_same_array(a, b)


def test_snapshot_to_device_keeps_values(tiny_data):
    pt, _ = tiny_data
    triples = pt_snapshots.split_by_time(pt.train)[0]
    host = pt_snapshots.build_snapshot(triples, pt.num_nodes, pt.num_rels, edge_bucket=32)
    dev = host.to("cpu")
    for f in ARRAY_FIELDS:
        t = getattr(dev, f)
        assert str(t.dtype) == ("torch.int64" if f in ("src", "dst", "rel", "rc_rel", "rc_ent")
                                else "torch.float32")
        np.testing.assert_array_equal(t.numpy(), getattr(host, f))
    assert (dev.num_edges, dev.num_triples, dev.dst_sorted) == (
        host.num_edges, host.num_triples, True)


@pytest.mark.parametrize("rel_mode", [False, True])
def test_answer_filters_equal(tiny_data, rel_mode):
    pt, _ = tiny_data
    got = pt_answers.build_answer_filters_by_time(pt.test, pt.num_rels, rel_mode)
    want = jax_answers.build_answer_filters_by_time(pt.test, pt.num_rels, rel_mode)
    assert len(got) == len(want) > 0
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.ans.keys() == w.ans.keys()
        for k in g.ans:
            assert_same_array(g.ans[k], w.ans[k])
        # the COO the evaluation scatters, over the padded query layout
        triples, _ = pt_snapshots.pad_triples(pt_snapshots.split_by_time(pt.test)[t],
                                              pt.num_rels, 128)
        cols = [0, 2] if rel_mode else [0, 1]
        tgt = triples[:, 1] if rel_mode else triples[:, 2]
        for a, b in zip(g.mask_coo(triples[:, cols], tgt), w.mask_coo(triples[:, cols], tgt)):
            assert_same_array(a, b)

"""The port's NYU loader, packed records, `cli prepare` and the records-first
`build_dataset` (ann3depth_tpu_torch/data/{nyu,records}.py, cli.py
`prepare`, train/loop.py), against the JAX package's, on the CPU.

Everything here is held exactly: the loaders are copies of the originals
(tests/test_torch_train_loop.py compares their source), and these tests
show that they read the same fixtures the same way.

- NYU fixtures are MATLAB v7.3 (HDF5) files written with h5py in the
  labeled file's layout, 16x20 frames: `images` (N,3,W,H) uint8, `depths`
  (N,W,H) f32 and, where a tier needs it, `scenes` as object references.
  Both loaders give the same split indices on all three tiers
  (splits.mat, alternating whole scenes, every other image) and the same
  (image, depth) pairs.
- Records packed by either package's `pack` are read by the other's
  `RecordDataset` (npy and npz) into equal batches for one seed, and the
  two packs' index JSON and arrays are the same.
- `cli prepare` writes what the JAX CLI's `prepare` writes and prints the
  same line up to the output directory.
- `build_dataset` takes `<data_dir>/records` before the raw files.
"""

import dataclasses
import json
import logging

import numpy as np
import pytest

from ann3depth_tpu.config import get_config as jget_config
from ann3depth_tpu.data import nyu as jnyu
from ann3depth_tpu.data import records as jrec
from ann3depth_tpu.train import loop as jloop
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.config import get_config
from ann3depth_tpu_torch.data import nyu as tnyu
from ann3depth_tpu_torch.data import records as trec
from ann3depth_tpu_torch.train import loop as tloop

H, W = 16, 20
SCENES = (["kitchen_0001"] * 3 + ["office_0002"] * 2 + ["bedroom_0003"] * 3
          + ["bathroom_0004"] * 2)


def write_nyu_mat(root, n, scenes=None, splits=None, seed=0):
    """A labeled-file fixture under root/nyu: n frames of HxW, with scene
    references and a splits.mat ({"trainNdxs": 1-based, "testNdxs": ...})
    when given."""
    import h5py
    import scipy.io

    rng = np.random.default_rng(seed)
    d = root / "nyu"
    d.mkdir(parents=True, exist_ok=True)
    with h5py.File(d / "nyu_depth_v2_labeled.mat", "w") as f:
        f.create_dataset("images", data=rng.integers(
            0, 256, (n, 3, W, H), dtype=np.uint8))
        f.create_dataset("depths", data=rng.uniform(
            0.5, 10.0, (n, W, H)).astype(np.float32))
        if scenes is not None:
            refs = []
            for i, s in enumerate(scenes):
                ds = f.create_dataset(f"#refs#/s{i}", data=np.array(
                    [[ord(c)] for c in s], dtype=np.uint16))
                refs.append(ds.ref)
            f.create_dataset("scenes", data=np.array(
                refs, dtype=h5py.ref_dtype).reshape(1, -1))
    if splits is not None:
        scipy.io.savemat(str(d / "splits.mat"),
                         {k: np.asarray(v).reshape(-1, 1)
                          for k, v in splits.items()})
    return root


TIERS = {
    "splits_mat": dict(n=10, scenes=SCENES,
                       splits={"trainNdxs": [1, 2, 4, 6, 9, 10],
                               "testNdxs": [3, 5, 7, 8]}),
    "scenes": dict(n=10, scenes=SCENES),
    "every_other_image": dict(n=7),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_nyu_loader_matches_original(tmp_path, tier, caplog):
    root = write_nyu_mat(tmp_path, **TIERS[tier])
    for split in ("train", "test"):
        with caplog.at_level(logging.WARNING):
            j = jnyu.NYUDataset(str(root), split=split)
            t = tnyu.NYUDataset(str(root), split=split)
        np.testing.assert_array_equal(t.indices, j.indices)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            (ji, jd), (ti, td) = j[i], t[i]
            assert ti.shape == (H, W, 3) and ti.dtype == np.uint8
            assert td.shape == (H, W) and td.dtype == np.float32
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(td, jd)
        for (a, b), (c, d) in zip(j.batches(2, steps=3, seed=4),
                                  t.batches(2, steps=3, seed=4)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        j.close()
        t.close()
    warned = any("every-other-IMAGE" in r.message for r in caplog.records
                 if r.name == tnyu.__name__)
    assert warned == (tier == "every_other_image")
    if tier == "scenes":  # kitchen, bedroom -> train; office, bathroom test
        np.testing.assert_array_equal(
            tnyu.NYUDataset(str(root), split="test").indices, [3, 4, 8, 9])
    if tier == "splits_mat":
        np.testing.assert_array_equal(
            tnyu.NYUDataset(str(root), split="train").indices,
            [0, 1, 3, 5, 8, 9])


def test_nyu_loader_refusals(tmp_path):
    with pytest.raises(FileNotFoundError, match="not found"):
        tnyu.NYUDataset(str(tmp_path))
    root = write_nyu_mat(tmp_path, n=4)
    with pytest.raises(ValueError, match="split must be"):
        tnyu.NYUDataset(str(root), split="val")


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_records_cross_read(tmp_path, fmt):
    """Each package packs the same NYU split; each reads the other's pack."""
    root = write_nyu_mat(tmp_path, n=10, scenes=SCENES)
    jdir, tdir = tmp_path / "jrec", tmp_path / "trec"
    jidx = jrec.pack(jnyu.NYUDataset(str(root)), str(jdir), "train",
                     shard_size=2, format=fmt)
    tidx = trec.pack(tnyu.NYUDataset(str(root)), str(tdir), "train",
                     shard_size=2, format=fmt)
    assert json.load(open(tidx)) == json.load(open(jidx))
    assert sorted(p.name for p in tdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())
    assert trec.find_index(str(tdir), "nyu", "train") == tidx
    assert trec.find_index(str(tdir), "nyu", "test") is None

    for a, b in ((jidx, tidx), (tidx, jidx)):  # (written by, read by)
        j, t = jrec.RecordDataset(a), trec.RecordDataset(a)
        assert len(t) == len(j) == 6 and t.name == "nyu"
        assert (t.gather is None) == (fmt == "npz")
        for i in range(len(j)):
            for x, y in zip(j[i], t[i]):
                np.testing.assert_array_equal(x, y)
        for (ji, jd), (ti, td) in zip(j.batches(4, steps=3, seed=7),
                                      t.batches(4, steps=3, seed=7)):
            np.testing.assert_array_equal(ji, ti)
            np.testing.assert_array_equal(jd, td)
        other = trec.RecordDataset(b)
        for i in range(len(j)):
            for x, y in zip(t[i], other[i]):
                np.testing.assert_array_equal(x, y)


def test_records_pickle_by_path_and_refuse_short_packs(tmp_path):
    import pickle

    root = write_nyu_mat(tmp_path, n=4)
    idx = trec.pack(tnyu.NYUDataset(str(root)), str(tmp_path / "r"), "train")
    ds = trec.RecordDataset(idx)
    assert pickle.loads(pickle.dumps(ds))._index_path == idx
    assert len(pickle.dumps(ds)) < 1000  # the path, not the memmaps
    meta = json.load(open(idx))
    meta["total"] += 1
    json.dump(meta, open(idx, "w"))
    with pytest.raises(ValueError, match="incomplete"):
        trec.RecordDataset(idx)
    with pytest.raises(ValueError, match="npy|npz"):
        trec.pack(tnyu.NYUDataset(str(root)), str(tmp_path / "x"), "train",
                  format="tar")


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_cli_prepare_matches_jax(tmp_path, capsys, fmt):
    from ann3depth_tpu import cli as jcli

    root = write_nyu_mat(tmp_path, n=10, scenes=SCENES)
    out = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        for split in ("train", "test"):
            rc = main(["prepare", "--dataset", "nyu", "--data-dir",
                       str(root), "--out-dir", str(tmp_path / name),
                       "--split", split, "--format", fmt,
                       "--shard-size", "3"])
            assert rc == 0
            line = json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
            out[name, split] = line
    for split, n in (("train", 6), ("test", 4)):
        j, t = out["jax", split], out["port", split]
        assert t["examples"] == j["examples"] == n
        assert t["index"] == str(tmp_path / "port" / f"nyu-{split}-"
                                 "index.json")
        assert json.load(open(t["index"])) == json.load(open(j["index"]))
        jd, td = jrec.RecordDataset(j["index"]), trec.RecordDataset(
            t["index"])
        for i in range(n):
            for x, y in zip(jd[i], td[i]):
                np.testing.assert_array_equal(x, y)


def test_cli_prepare_defaults_to_data_dir_records(tmp_path, capsys):
    root = write_nyu_mat(tmp_path, n=4)
    assert cli.main(["prepare", "--dataset", "nyu", "--data-dir",
                     str(root)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"index": str(root / "records" / "nyu-train-index.json"),
                    "examples": 2}


def test_build_dataset_prefers_records(tmp_path):
    root = write_nyu_mat(tmp_path, n=10, scenes=SCENES)

    def cfgs(name):
        return [dataclasses.replace(c, data=dataclasses.replace(
            c.data, datasets=(name,), data_dir=str(root)))
            for c in (jget_config("nyu-encdec-aug"),
                      get_config("nyu-encdec-aug"))]

    jcfg, tcfg = cfgs("nyu")
    raw = tloop.build_dataset(tcfg, "train")
    assert isinstance(raw, tnyu.NYUDataset)
    assert isinstance(jloop.build_dataset(jcfg, "train"), jnyu.NYUDataset)
    trec.pack(tnyu.NYUDataset(str(root), split="test"),
              str(root / "records"), "test")
    trec.pack(raw, str(root / "records"), "train")
    for split in ("train", "test"):
        got = tloop.build_dataset(tcfg, split)
        want = jloop.build_dataset(jcfg, split)
        assert isinstance(got, trec.RecordDataset)
        assert isinstance(want, jrec.RecordDataset)
        for (a, b), (c, d) in zip(want.batches(2, steps=2, seed=1),
                                  got.batches(2, steps=2, seed=1)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # records need no raw files: make3d packed, with no Make3D tree
    trec.pack(raw, str(tmp_path / "m" / "records"), "train")
    (tmp_path / "m" / "records" / "nyu-train-index.json").rename(
        tmp_path / "m" / "records" / "make3d-train-index.json")
    mcfg = dataclasses.replace(tcfg, data=dataclasses.replace(
        tcfg.data, datasets=("make3d",), data_dir=str(tmp_path / "m")))
    assert isinstance(tloop.build_dataset(mcfg), trec.RecordDataset)
    with pytest.raises(KeyError, match="unknown dataset"):
        tloop.build_dataset(tcfg, name="kitti")

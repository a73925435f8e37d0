"""The port's dataset download (ann3depth_tpu_torch/data/download.py and
`cli download`) on staged archives, on the CPU.

The module is a copy of the JAX package's (tests/test_torch_train_loop.py
holds the two texts equal up to imports); these tests replay the JAX
package's download cases (tests/test_data_loaders.py) on the port's
module, and drive `cli download` into a Make3D tree that the port's
loader reads. Every archive is staged before a download runs: no test
reaches the network.
"""

import gzip
import io
import json
import tarfile

import numpy as np
import pytest

from ann3depth_tpu.data import download as jdl
from ann3depth_tpu_torch import cli
from ann3depth_tpu_torch.data import download as dl
from ann3depth_tpu_torch.data.make3d import Make3DDataset

MAKE3D_DIRS = (("Train400Img.tar.gz", "Train400Img", "img-{}.jpg"),
               ("Train400Depth.tgz", "Train400Depth",
                "depth_sph_corr-{}.mat"),
               ("Test134.tar.gz", "Test134", "img-{}.jpg"),
               ("Test134Depth.tar.gz", "Gridlaserdata",
                "depth_sph_corr-{}.mat"))


@pytest.mark.parametrize("name", ["ARCHIVES", "CHECKSUMS", "RECORDED_NAME",
                                  "EXPECTED_LAYOUT", "MAKE3D_BASE",
                                  "NYU_BASE"])
def test_constants_match_jax(name):
    assert getattr(dl, name) == getattr(jdl, name)


def _stage_make3d(data_dir, ids=("a", "b"), hw=(8, 8)):
    """The four Make3D archives under <data_dir>/make3d/, each holding one
    directory of the extracted layout: scenes `ids[0]` (train) and
    `ids[1]` (test), RGB at `hw` and Position3DGrid (55, 305, 4)."""
    import scipy.io
    from PIL import Image

    base = data_dir / "make3d"
    base.mkdir(parents=True)
    src = data_dir / "src"
    rng = np.random.default_rng(0)
    for (archive, sub, pattern), sid in zip(MAKE3D_DIRS,
                                            (ids[0], ids[0], ids[1], ids[1])):
        (src / sub).mkdir(parents=True)
        if pattern.startswith("img"):
            Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                            ).save(src / sub / pattern.format(sid))
        else:
            grid = np.zeros((55, 305, 4), np.float32)
            grid[..., 3] = rng.uniform(1, 70, (55, 305))
            scipy.io.savemat(src / sub / pattern.format(sid),
                             {"Position3DGrid": grid})
        with tarfile.open(base / archive, "w:gz") as tf:
            tf.add(src / sub, arcname=sub)
    return base


def test_download_staged_archive_verified_and_extracted(tmp_path):
    base = _stage_make3d(tmp_path)
    dl.download("make3d", str(tmp_path))  # offline: uses staged archives
    assert (base / "Train400Img" / "img-a.jpg").exists()
    assert (base / "Gridlaserdata" / "depth_sph_corr-b.mat").exists()


def test_download_truncated_archive_fails_fast(tmp_path):
    base = tmp_path / "make3d"
    base.mkdir()
    with gzip.open(base / "Train400Img.tar.gz", "wb") as f:
        f.write(b"this is not a tarball")
    with pytest.raises(RuntimeError, match="corrupt or truncated"):
        dl._verify_archive(str(base / "Train400Img.tar.gz"))


def test_download_bad_mat_magic_fails(tmp_path):
    p = tmp_path / "nyu_depth_v2_labeled.mat"
    p.write_bytes(b"MATLAB 5.0 MAT-file junk header")
    with pytest.raises(RuntimeError, match="HDF5"):
        dl._verify_archive(str(p))


def test_download_checksum_enforced_when_known(tmp_path, monkeypatch):
    p = tmp_path / "Test134.tar.gz"
    p.write_bytes(b"anything")
    monkeypatch.setitem(dl.CHECKSUMS, "Test134.tar.gz", "0" * 64)
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        dl._verify_archive(str(p))


def test_download_layout_verification_reports_missing(tmp_path):
    (tmp_path / "make3d" / "Train400Img").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="incomplete"):
        dl._verify_layout("make3d", str(tmp_path / "make3d"))


def _v73_mat(path):
    """A MATLAB v7.3 file: HDF5 behind a 512-byte MATLAB userblock."""
    import h5py

    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("depths", data=np.zeros((2, 4, 3), np.float32))
    with open(path, "r+b") as f:
        f.write(b"MATLAB 7.3 MAT-file".ljust(116, b" "))
        f.seek(124)
        f.write(b"\x00\x02IM")


def test_download_v73_mat_with_userblock_verifies(tmp_path):
    p = tmp_path / "nyu_depth_v2_labeled.mat"
    _v73_mat(p)
    dl._verify_archive(str(p))  # must not raise


def _tar_one(p, payload):
    with tarfile.open(p, "w:gz") as tf:
        ti = tarfile.TarInfo("Test134/img-test0000.jpg")
        ti.size = len(payload)
        tf.addfile(ti, io.BytesIO(payload))


def test_recorded_checksums_become_hard_gates(tmp_path):
    base = tmp_path / "make3d"
    base.mkdir()
    p = base / "Test134.tar.gz"
    _tar_one(p, b"abc")
    dl._verify_archive(str(p))  # no gate yet
    rec = dl.record_checksums("make3d", str(tmp_path))
    assert "Test134.tar.gz" in rec
    dl._verify_archive(str(p))  # matches its own recording
    _tar_one(p, b"xyz")  # same name, other bytes, still a valid tarball
    with pytest.raises(RuntimeError, match="sha256 mismatch.*checksums.json"):
        dl._verify_archive(str(p))


def test_builtin_checksums_outrank_recorded(tmp_path, monkeypatch):
    base = tmp_path / "make3d"
    base.mkdir()
    p = base / "Test134.tar.gz"
    p.write_bytes(b"payload")
    (base / dl.RECORDED_NAME).write_text(
        json.dumps({"Test134.tar.gz": dl._sha256(str(p))}))
    monkeypatch.setitem(dl.CHECKSUMS, "Test134.tar.gz", "0" * 64)
    with pytest.raises(RuntimeError, match="builtin CHECKSUMS"):
        dl._verify_archive(str(p))


def test_unknown_dataset_raises():
    with pytest.raises(KeyError, match="unknown dataset 'kitti'"):
        dl.download("kitti", "data")


def test_cli_download_make3d_tree_loads(tmp_path):
    """`cli download --record-checksums` extracts the staged archives and
    records their sums; a second download verifies against them and a
    changed archive then fails; the port's Make3D loader reads the tree."""
    base = _stage_make3d(tmp_path, hw=(48, 64))
    argv = ["download", "--dataset", "make3d", "--data-dir", str(tmp_path)]
    assert cli.main(argv + ["--record-checksums"]) == 0
    recorded = json.loads((base / dl.RECORDED_NAME).read_text())
    assert sorted(recorded) == sorted(a for a, _, _ in MAKE3D_DIRS)
    assert cli.main(argv) == 0
    for split, sid in (("train", "a"), ("test", "b")):
        ds = Make3DDataset(str(tmp_path), split=split, raw_hw=(48, 64))
        assert len(ds) == 1 and ds.pairs[0][0].endswith(f"img-{sid}.jpg")
        img, depth = ds[0]
        assert img.shape == (48, 64, 3) and depth.shape == (305, 55)
    _tar_one(base / "Test134.tar.gz", b"xyz")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        cli.main(argv)


def test_cli_download_nyu_staged_mat(tmp_path):
    (tmp_path / "nyu").mkdir()
    _v73_mat(tmp_path / "nyu" / "nyu_depth_v2_labeled.mat")
    assert cli.main(["download", "--dataset", "nyu", "--data-dir",
                     str(tmp_path), "--record-checksums"]) == 0
    assert "nyu_depth_v2_labeled.mat" in json.loads(
        (tmp_path / "nyu" / dl.RECORDED_NAME).read_text())


def test_missing_tree_points_at_the_port_cli(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m ann3depth_tpu_torch download"):
        Make3DDataset(str(tmp_path), split="train")

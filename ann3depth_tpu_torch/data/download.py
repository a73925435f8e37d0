"""Dataset acquisition: fetch + extract Make3D / NYU archives (SURVEY §2.1
"Dataset downloader", §3.4). One-shot, host-only, I/O bound.

A copy of `ann3depth_tpu/data/download.py`, so that the port imports nothing of
the JAX package; tests/test_torch_download.py replays its tests on it.

Offline-safe: this environment has no network (SURVEY §0 [ENV]), so every
fetch is gated — if the archive is already present (pre-populated data dir)
we extract/verify and continue; otherwise we fail with the exact URL list so
a user can stage files manually. Layout produced:

    <data_dir>/make3d/
        Train400Img/         img-*.jpg
        Train400Depth/       depth_sph_corr-*.mat   (Position3DGrid 55x305x4)
        Test134/             img-*.jpg
        Gridlaserdata/       depth_sph_corr-*.mat
    <data_dir>/nyu/
        nyu_depth_v2_labeled.mat                    (HDF5 v7.3)
"""

from __future__ import annotations

import logging
import os
import tarfile
import urllib.error
import urllib.request

log = logging.getLogger(__name__)

MAKE3D_BASE = "http://cs.stanford.edu/group/reconstruction3d"
NYU_BASE = "http://horatio.cs.nyu.edu/mit/silberman/nyu_depth_v2"

ARCHIVES = {
    "make3d": [
        # (url, extract_into_subdir)
        (f"{MAKE3D_BASE}/Train400Img.tar.gz", "make3d"),
        (f"{MAKE3D_BASE}/Train400Depth.tgz", "make3d"),
        (f"{MAKE3D_BASE}/Test134.tar.gz", "make3d"),
        (f"{MAKE3D_BASE}/Test134Depth.tar.gz", "make3d"),
    ],
    "nyu": [
        (f"{NYU_BASE}/nyu_depth_v2_labeled.mat", "nyu"),
    ],
}

# sha256 per archive basename, enforced when set. The values are unknowable
# in this offline environment (no network, no reference artifacts); once
# known they become hard gates. Runtime-recorded hashes (see
# `download --record-checksums`) live in <data_dir>/<dataset>/checksums.json
# and are enforced the same way on every later verify.
CHECKSUMS: dict = {
    "Train400Img.tar.gz": None,
    "Train400Depth.tgz": None,
    "Test134.tar.gz": None,
    "Test134Depth.tar.gz": None,
    "nyu_depth_v2_labeled.mat": None,
}

RECORDED_NAME = "checksums.json"


def _sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _expected_sha(path: str):
    """Builtin CHECKSUMS first (authoritative), else the recorded
    checksums.json sitting next to the archive. Returns (sha|None, source)."""
    base = os.path.basename(path)
    want = CHECKSUMS.get(base)
    if want is not None:
        return want, "builtin CHECKSUMS"
    rec = os.path.join(os.path.dirname(path), RECORDED_NAME)
    if os.path.exists(rec):
        import json

        want = json.load(open(rec)).get(base)
        if want is not None:
            return want, rec
    return None, None


def record_checksums(dataset: str, data_dir: str) -> dict:
    """Write sha256 of every staged archive of `dataset` into
    <data_dir>/<dataset>/checksums.json. From then on _verify_archive
    enforces them — first verified staging becomes a hard gate against
    later corruption or silent replacement."""
    import json

    base = os.path.join(data_dir, dataset)
    rec_path = os.path.join(base, RECORDED_NAME)
    recorded = json.load(open(rec_path)) if os.path.exists(rec_path) else {}
    for url, _sub in ARCHIVES[dataset]:
        p = os.path.join(base, os.path.basename(url))
        if os.path.exists(p):
            recorded[os.path.basename(url)] = _sha256(p)
    tmp = rec_path + ".part"
    with open(tmp, "w") as f:
        json.dump(recorded, f, indent=1, sort_keys=True)
    os.replace(tmp, rec_path)
    log.info("recorded %d checksum(s) -> %s", len(recorded), rec_path)
    return recorded

# Post-extract layout: (subpath-under-<data_dir>/<dataset>, glob, min count).
EXPECTED_LAYOUT = {
    "make3d": [
        ("Train400Img", "*.jpg", 1),
        ("Train400Depth", "*.mat", 1),
        ("Test134", "*.jpg", 1),
        ("Gridlaserdata", "*.mat", 1),
    ],
    "nyu": [
        ("", "nyu_depth_v2_labeled.mat", 1),
    ],
}

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def _fetch(url: str, dest: str) -> bool:
    """Download url -> dest. Returns False (with log) when offline."""
    if os.path.exists(dest):
        return True
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    tmp = dest + ".part"
    try:
        log.info("fetching %s", url)
        with urllib.request.urlopen(url, timeout=30) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
        return True
    except (urllib.error.URLError, OSError) as e:
        log.warning("fetch failed (%s); offline?", e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _verify_archive(path: str) -> None:
    """Fail fast (not mid-epoch) on truncated/corrupt staged archives.

    Tarballs: walk every member header (detects truncation without a full
    decompress of file payloads). .mat: must be a MATLAB v7.3 = HDF5 file
    (magic bytes). Checksums from CHECKSUMS enforced when known.
    """
    want, source = _expected_sha(path)
    if want is not None:
        got = _sha256(path)
        if got != want:
            raise RuntimeError(
                f"{path}: sha256 mismatch (got {got}, want {want} per "
                f"{source}) — delete and re-stage the archive")
    if path.endswith((".tar.gz", ".tgz", ".tar")):
        try:
            with tarfile.open(path) as tf:
                n = sum(1 for _ in tf)
        except (tarfile.TarError, EOFError, OSError) as e:
            raise RuntimeError(
                f"{path}: corrupt or truncated archive ({e}) — delete and "
                "re-stage it") from e
        if n == 0:
            raise RuntimeError(f"{path}: archive contains no members")
    elif path.endswith(".mat"):
        # Real MATLAB v7.3 files carry a 512-byte userblock (the MATLAB
        # text header); the HDF5 signature then sits at offset 512. The
        # HDF5 spec allows the signature at 0, 512, 1024, ... — probe the
        # offsets a .mat can plausibly use. (Checking only offset 0 would
        # reject every genuine NYU download; caught by the r4 true-scale
        # dress rehearsal.)
        with open(path, "rb") as f:
            ok = False
            for off in (0, 512, 1024):
                f.seek(off)
                if f.read(8) == _HDF5_MAGIC:
                    ok = True
                    break
            if not ok:
                raise RuntimeError(
                    f"{path}: not a MATLAB v7.3 (HDF5) file — wrong or "
                    "truncated download")


def _verify_layout(dataset: str, base: str) -> None:
    """Post-extract check: the loaders' expected tree exists and is non-empty."""
    import glob as globlib

    problems = []
    for sub, pattern, min_n in EXPECTED_LAYOUT[dataset]:
        matches = globlib.glob(os.path.join(base, sub, pattern))
        if len(matches) < min_n:
            problems.append(f"{os.path.join(sub, pattern) or pattern}: "
                            f"{len(matches)} files (need >= {min_n})")
    if problems:
        raise RuntimeError(
            f"{dataset} layout under {base} is incomplete after extraction:"
            "\n  " + "\n  ".join(problems))


def download(dataset: str, data_dir: str, record: bool = False) -> None:
    """Ensure `dataset` is laid out under data_dir; fetch if reachable.

    Every staged archive is integrity-checked (headers walked, HDF5 magic,
    sha256 when known — builtin or previously recorded) and the extracted
    tree is layout-verified, so a truncated download fails here with a
    clear message instead of mid-epoch. record=True writes the verified
    archives' sha256 into <data_dir>/<dataset>/checksums.json, turning
    this staging into a hard gate for every later run.
    """
    if dataset not in ARCHIVES:
        raise KeyError(f"unknown dataset {dataset!r}; have {sorted(ARCHIVES)}")
    missing = []
    for url, sub in ARCHIVES[dataset]:
        fname = os.path.join(data_dir, sub, os.path.basename(url))
        if _fetch(url, fname):
            _verify_archive(fname)
            _extract(fname, os.path.join(data_dir, sub))
        else:
            missing.append(url)
    if missing:
        raise RuntimeError(
            f"could not fetch {dataset} archives (offline?). Stage these "
            f"files under {os.path.join(data_dir, dataset)}/ manually:\n  "
            + "\n  ".join(missing))
    _verify_layout(dataset, os.path.join(data_dir, dataset))
    if record:
        record_checksums(dataset, data_dir)
    log.info("%s ready under %s", dataset, data_dir)


def _extract(archive: str, into: str) -> None:
    if archive.endswith((".tar.gz", ".tgz", ".tar")):
        log.info("extracting %s", archive)
        with tarfile.open(archive) as tf:
            tf.extractall(into, filter="data")
    # .mat archives (NYU) are used in place, no extraction.

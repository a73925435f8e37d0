"""The port's input pipeline (ann3depth_tpu_torch/pipeline/{feed,
device_cache,streaming_pool,grain_loader}.py) on the CPU, case by case
against tests/test_feed.py, test_device_cache.py, test_streaming_pool.py and
test_grain_loader.py, and against the JAX package's samplers:

- the device pool's index stream, index blocks and fixed batches equal
  the JAX DevicePoolSampler's bit for bit at the same seed on a one-device
  mesh (the port's single device);
- the window pool's window permutations, echo permutations and index
  blocks equal the JAX StreamingPoolSampler's bit for bit;
- pick_window_epochs equals the JAX function on a grid of inputs;
- every error the JAX samplers raise is raised with the same message.

Frames are 16x16 synthetic scenes, as the JAX tests use.
"""

import time

import jax
import numpy as np
import pytest
import torch

from ann3depth_tpu.parallel import mesh as meshlib
from ann3depth_tpu.pipeline import device_cache as jdc
from ann3depth_tpu.pipeline import streaming_pool as jsp
from ann3depth_tpu_torch.data.synthetic import SyntheticDepthDataset
from ann3depth_tpu_torch.pipeline import device_cache as tdc
from ann3depth_tpu_torch.pipeline import streaming_pool as tsp
from ann3depth_tpu_torch.pipeline.feed import DeviceFeed
from ann3depth_tpu_torch.pipeline.grain_loader import grain_batches

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def one_mesh():
    return meshlib.create_mesh([jax.devices("cpu")[0]])


def _ds(n, hw=(16, 16), dhw=(8, 8), seed=0):
    return SyntheticDepthDataset(n=n, img_hw=hw, depth_hw=dhw, seed=seed)


def _ids(ds, batches):
    """Map gathered batches back to dataset indices (exact match)."""
    all_imgs = np.stack([ds[i][0] for i in range(len(ds))])
    out = []
    for img, _ in batches:
        for row in np.asarray(img):
            (i,) = np.nonzero((all_imgs == row).all(axis=(1, 2, 3)))[0][:1]
            out.append(int(i))
    return out


def _window_bytes(ds, examples):
    img0, dep0 = ds[0]
    return examples * (img0.nbytes + dep0.nbytes)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# ---------------------------------------------------------------------------
# DeviceFeed (tests/test_feed.py).
# ---------------------------------------------------------------------------

def _batches(n, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise RuntimeError("loader exploded")
        yield (np.full((2, 4), i, np.float32),)


def test_feed_yields_all_batches_in_order():
    feed = DeviceFeed(_batches(5), prefetch=2)
    seen = [int(b[0][0, 0]) for b in feed]
    assert seen == [0, 1, 2, 3, 4]


def test_feed_hands_out_cpu_tensors_of_the_host_bytes():
    host = [(np.random.default_rng(i).integers(0, 256, (2, 4, 4, 3),
                                               dtype=np.uint8),
             np.full((2, 3), i, np.float32)) for i in range(4)]
    got = list(DeviceFeed(iter(host), device="cpu", prefetch=1))
    assert len(got) == 4
    for (img, dep), (want_img, want_dep) in zip(got, host):
        assert isinstance(img, torch.Tensor) and img.device == CPU
        assert img.dtype == torch.uint8 and dep.dtype == torch.float32
        assert np.array_equal(img.numpy(), want_img)
        assert np.array_equal(dep.numpy(), want_dep)


def test_feed_propagates_worker_error():
    feed = DeviceFeed(_batches(10, fail_at=3), prefetch=2)
    got = []
    with pytest.raises(RuntimeError, match="loader exploded"):
        for b in feed:
            got.append(int(b[0][0, 0]))
    assert got == [0, 1, 2]


def test_feed_close_unblocks_producer():
    """close() must terminate a worker blocked on a full queue."""
    def slow_infinite():
        i = 0
        while True:
            yield (np.full((1,), i, np.float32),)
            i += 1

    feed = DeviceFeed(slow_infinite(), prefetch=1)
    next(feed)
    feed.close()
    t0 = time.time()
    feed._thread.join(timeout=5)
    assert not feed._thread.is_alive()
    assert time.time() - t0 < 5


def test_feed_prefetch_overlaps():
    """The worker runs ahead: after consuming batch 0, later batches are
    already staged (queue non-empty without waiting)."""
    feed = DeviceFeed(_batches(4), prefetch=2)
    next(feed)
    time.sleep(0.2)
    assert feed._q.qsize() >= 1
    feed.close()


# ---------------------------------------------------------------------------
# DevicePoolSampler (tests/test_device_cache.py, test_scan_dispatch.py).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch,steps,seed", [
    (32, 8, 6, 3), (16, 4, None, 0), (24, 5, 11, 7)])
def test_index_stream_equals_jax(one_mesh, n, batch, steps, seed):
    ds = _ds(n)
    j = jdc.DevicePoolSampler(ds, batch, one_mesh, steps=steps, seed=seed)
    t = tdc.DevicePoolSampler(ds, batch, CPU, steps=steps, seed=seed)
    want, got = list(j._local_index_stream()), list(t._local_index_stream())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    j.close(), t.close()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_index_blocks_equal_jax(one_mesh, k):
    ds = _ds(32)
    j = jdc.DevicePoolSampler(ds, 8, one_mesh, steps=6, seed=3)
    t = tdc.DevicePoolSampler(ds, 8, CPU, steps=6, seed=3)
    want = [np.asarray(jax.device_get(x)) for x in j.index_blocks(k)]
    got = [x.numpy() for x in t.index_blocks(k)]
    assert len(got) == len(want) == 6 // k and got[0].shape == (k, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # index_blocks(k) is __iter__'s order, grouped (test_scan_dispatch.py)
    per_step = list(tdc.DevicePoolSampler(ds, 8, CPU, steps=6,
                                          seed=3)._local_index_stream())
    np.testing.assert_array_equal(np.concatenate(got), np.stack(per_step))
    j.close(), t.close()


def test_fixed_batches_equal_jax_and_repeat(one_mesh):
    ds = _ds(16)
    j = jdc.DevicePoolSampler(ds, 4, one_mesh, steps=0, seed=0)
    t = tdc.DevicePoolSampler(ds, 4, CPU, steps=0, seed=0)
    want = [np.asarray(jax.device_get(img)) for img, _ in j.fixed_batches(3)]
    got = [img.numpy() for img, _ in t.fixed_batches(3)]
    again = [img.numpy() for img, _ in t.fixed_batches(3)]
    for a, b, c in zip(got, want, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert _message(lambda: next(t.fixed_batches(5))) == _message(
        lambda: next(j.fixed_batches(5)))


def test_batches_are_the_pool_rows_of_the_stream():
    ds = _ds(32, hw=(24, 32), dhw=(12, 16))
    sampler = tdc.DevicePoolSampler(ds, 8, CPU, steps=6, seed=0)
    stream = list(tdc.DevicePoolSampler(ds, 8, CPU, steps=6,
                                        seed=0)._local_index_stream())
    batches = list(sampler)
    assert len(batches) == 6
    for (img, dep), idx in zip(batches, stream):
        assert img.shape == (8, 24, 32, 3) and dep.shape == (8, 12, 16)
        assert img.dtype == torch.uint8 and dep.dtype == torch.float32
        for row, i in zip(range(8), idx):
            np.testing.assert_array_equal(img[row].numpy(), ds[int(i)][0])
            np.testing.assert_array_equal(dep[row].numpy(), ds[int(i)][1])


def test_epoch_covers_the_pool_without_replacement():
    ds = _ds(16)
    sampler = tdc.DevicePoolSampler(ds, 4, CPU, steps=4, seed=0)
    ids = _ids(ds, sampler)
    assert sorted(ids) == list(range(16))


def test_steps_none_is_one_epoch():
    sampler = tdc.DevicePoolSampler(_ds(16), 8, CPU, steps=None, seed=0)
    assert sum(1 for _ in sampler) == 2


@pytest.mark.parametrize("batch,kw", [
    (32, {}), (0, {}), (8, {"byte_budget": 1000})])
def test_sampler_errors_equal_jax(one_mesh, batch, kw):
    ds = _ds(16)
    assert _message(lambda: tdc.DevicePoolSampler(ds, batch, CPU, **kw)) \
        == _message(lambda: jdc.DevicePoolSampler(ds, batch, one_mesh, **kw))


def test_index_blocks_reject_what_jax_rejects(one_mesh):
    ds = _ds(32)
    t = tdc.DevicePoolSampler(ds, 8, CPU, steps=6, seed=0)
    j = jdc.DevicePoolSampler(ds, 8, one_mesh, steps=6, seed=0)
    for k in (0, 4):
        got = _message(lambda: next(t.index_blocks(k)))
        want = _message(lambda: next(j.index_blocks(k)))
        assert got == want.replace("scanned program", "K-step dispatch")


@pytest.mark.parametrize("chunk_examples", [1, 3, 100])
def test_chunked_staging_matches_dataset(chunk_examples):
    """Pool contents are exactly dataset rows [0, n) however many staging
    chunks the host-memory bound forces."""
    ds = _ds(24)
    ex = _window_bytes(ds, 1)
    sampler = tdc.DevicePoolSampler(ds, 8, CPU, steps=1, seed=0,
                                    stage_chunk_bytes=chunk_examples * ex)
    np.testing.assert_array_equal(sampler.pool_img.numpy(),
                                  np.stack([ds[i][0] for i in range(24)]))
    np.testing.assert_array_equal(sampler.pool_dep.numpy(),
                                  np.stack([ds[i][1] for i in range(24)]))
    sampler.close()
    assert sampler.pool_img is None


def test_cache_device_from_packed_records(tmp_path):
    from ann3depth_tpu_torch.data.records import RecordDataset, pack

    ds = _ds(16, hw=(24, 32), dhw=(12, 16))
    rec = RecordDataset(pack(ds, str(tmp_path), "train", shard_size=5))
    batches = list(tdc.DevicePoolSampler(rec, 8, CPU, steps=2, seed=0))
    assert len(batches) == 2
    assert batches[0][0].shape == (8, 24, 32, 3)


def test_stack_dataset_equals_jax_and_needs_uniform_shapes():
    ds = _ds(5)
    for a, b in zip(tdc.stack_dataset(ds), jdc.stack_dataset(ds)):
        np.testing.assert_array_equal(a, b)

    class Ragged:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return (np.zeros((4 + i, 4, 3), np.uint8),
                    np.zeros((2, 2), np.float32))

    assert _message(lambda: tdc.stack_dataset(Ragged())) == _message(
        lambda: jdc.stack_dataset(Ragged()))
    with pytest.raises(ValueError, match="uniform example shapes"):
        tdc.DevicePoolSampler(Ragged(), 1, CPU)


# ---------------------------------------------------------------------------
# StreamingPoolSampler (tests/test_streaming_pool.py).
# ---------------------------------------------------------------------------

def test_window_stream_equals_jax(one_mesh):
    """Window permutations, echo permutations and index blocks, bit for
    bit, over two passes with echoing."""
    ds = _ds(48)
    kw = dict(window_bytes=_window_bytes(ds, 16), window_epochs=2, steps=24,
              seed=5)
    j = jsp.StreamingPoolSampler(ds, 8, one_mesh, **kw)
    t = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    jw, tw = j._window_perms(), t._window_perms()
    for _ in range(7):
        np.testing.assert_array_equal(next(tw), next(jw))
    for _ in range(3):
        for a, b in zip(t._window_local_indices(),
                        j._window_local_indices()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    j.close(), t.close()
    j = jsp.StreamingPoolSampler(ds, 8, one_mesh, **kw)
    t = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    want = [np.asarray(jax.device_get(b)) for b in j.index_blocks(2)]
    got = [b.numpy() for b in t.index_blocks(2)]
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    j.close(), t.close()


def test_window_batches_equal_jax_batches(one_mesh):
    """The same examples in the same order, window after window."""
    ds = _ds(32)
    kw = dict(window_bytes=_window_bytes(ds, 16), steps=8, seed=7)
    j = jsp.StreamingPoolSampler(ds, 8, one_mesh, **kw)
    t = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    want = [np.asarray(jax.device_get(img)) for img, _ in j]
    got = [img.numpy() for img, _ in t]
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    j.close(), t.close()


def test_one_pass_covers_dataset_exactly_once():
    ds = _ds(32)
    sampler = tsp.StreamingPoolSampler(
        ds, 8, CPU, window_bytes=_window_bytes(ds, 16), steps=None, seed=0)
    assert sampler.win == 16 and sampler.windows_per_pass == 2
    ids = _ids(ds, list(sampler))
    sampler.close()
    assert sorted(ids) == list(range(32))


def test_echo_repeats_each_window_example_e_times():
    ds = _ds(32)
    sampler = tsp.StreamingPoolSampler(
        ds, 8, CPU, window_bytes=_window_bytes(ds, 16), window_epochs=3,
        steps=None, seed=0)
    assert sampler.steps_per_window == 6
    batches = [(img.clone(), dep) for img, dep in sampler]
    sampler.close()
    ids = _ids(ds, batches)
    assert len(ids) == 2 * 3 * 16
    assert (np.bincount(ids, minlength=32) == 3).all()
    first = _ids(ds, batches[:6])
    assert len(set(first)) == 16
    assert all(first.count(i) == 3 for i in set(first))


def test_fresh_permutation_each_pass():
    ds = _ds(32)
    sampler = tsp.StreamingPoolSampler(
        ds, 8, CPU, window_bytes=_window_bytes(ds, 16), steps=8, seed=0)
    batches = [(img.clone(), dep) for img, dep in sampler]
    sampler.close()
    assert len(batches) == 8
    pass1, pass2 = _ids(ds, batches[:4]), _ids(ds, batches[4:])
    assert sorted(pass1) == sorted(pass2) == list(range(32))
    assert set(_ids(ds, batches[:2])) != set(_ids(ds, batches[4:6]))


def test_index_blocks_walk_the_iter_stream():
    """Gathering each block's rows from the active window (which
    index_blocks switches before a window's first block) gives __iter__'s
    batches."""
    ds = _ds(32)
    kw = dict(window_bytes=_window_bytes(ds, 16), steps=8, seed=7)
    ref = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    want = [img.clone().numpy() for img, _ in ref]
    ref.close()
    spd = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    got = []
    for block in spd.index_blocks(2):
        for row in block:
            got.append(spd.gather(row)[0].numpy())
    spd.close()
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_index_blocks_reject_a_window_spanning_k(one_mesh):
    ds = _ds(32)
    kw = dict(window_bytes=_window_bytes(ds, 16), steps=8, seed=0)
    t = tsp.StreamingPoolSampler(ds, 8, CPU, **kw)
    j = jsp.StreamingPoolSampler(ds, 8, one_mesh, **kw)
    got = _message(lambda: next(t.index_blocks(3)))
    want = _message(lambda: next(j.index_blocks(3)))
    assert "divide the window" in got
    assert got == want.replace("scanned block", "K-step block")
    t.close(), j.close()


@pytest.mark.parametrize("examples,kw", [
    (32, {}), (4, {}), (16, {"byte_budget": "window"}),
    (16, {"window_epochs": 0})])
def test_window_errors_equal_jax(one_mesh, examples, kw):
    ds = _ds(32)
    wb = _window_bytes(ds, examples)
    kw = {k: (wb if v == "window" else v) for k, v in kw.items()}
    assert _message(lambda: tsp.StreamingPoolSampler(
        ds, 8, CPU, window_bytes=wb, **kw)) == _message(
        lambda: jsp.StreamingPoolSampler(ds, 8, one_mesh, window_bytes=wb,
                                         **kw))


@pytest.mark.parametrize("args,kw", [
    ((10.0, 1.0, 4), {}), ((0.5, 1.0, 4), {}), ((0.0, 1.0, 4), {}),
    ((10.0, 3.0, 4), {}), ((10.0, 3.0, 4), {"steps_per_dispatch": 8}),
    ((2.9, 1.0, 4), {"steps_per_dispatch": 8}),
    ((1000.0, 0.001, 4), {"max_epochs": 16}),
    ((1000.0, 0.001, 4), {"steps_per_dispatch": 3, "max_epochs": 16}),
    ((7.3, 0.25, 3), {"steps_per_dispatch": 10}),
    ((1e4, 1e-3, 2), {})])
def test_pick_window_epochs_equals_jax(args, kw):
    assert tsp.pick_window_epochs(*args, **kw) == \
        jsp.pick_window_epochs(*args, **kw)


def test_pick_window_epochs_errors_equal_jax():
    for args, kw in (((-1.0, 1.0, 4), {}),
                     ((1e3, 1e-3, 1), {"steps_per_dispatch": 7,
                                       "max_epochs": 4})):
        assert _message(lambda: tsp.pick_window_epochs(*args, **kw)) == \
            _message(lambda: jsp.pick_window_epochs(*args, **kw))


def test_calibrate_window_epochs():
    """The probe stages one measured window, runs the caller's pass twice
    (warm-up + timed), and returns a factor on the dispatch quantum."""
    ds = _ds(32)
    calls = []

    def run_pass(probe, blocks):
        calls.append(sum(1 for _ in blocks))

    e = tsp.calibrate_window_epochs(
        ds, 8, CPU, window_bytes=_window_bytes(ds, 16), run_pass=run_pass,
        steps_per_dispatch=4)
    assert e >= 1 and (2 * e) % 4 == 0
    assert calls == [2, 2]


def test_no_overstaging_beyond_consumed_windows():
    ds = _ds(32)
    for use_blocks in (False, True):
        sampler = tsp.StreamingPoolSampler(
            ds, 8, CPU, window_bytes=_window_bytes(ds, 16), steps=4, seed=0)
        out = (list(sampler.index_blocks(2)) if use_blocks
               else list(sampler))
        assert len(out) == (2 if use_blocks else 4)
        assert sampler._pending == 0
        sampler.close()


def test_partial_final_window_stages_no_extra():
    ds = _ds(48)
    sampler = tsp.StreamingPoolSampler(
        ds, 8, CPU, window_bytes=_window_bytes(ds, 16), steps=3, seed=0)
    assert len(list(sampler)) == 3
    assert sampler._pending == 0
    sampler.close()


def test_staging_error_surfaces():
    """A dataset read that fails in the staging thread is raised in the
    consumer."""
    ds = _ds(32)

    class Broken:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            if i:
                raise OSError("disk gone")
            return ds[0]

    sampler = tsp.StreamingPoolSampler(
        Broken(), 8, CPU, window_bytes=_window_bytes(ds, 16), steps=4)
    with pytest.raises(RuntimeError, match="staging worker failed"):
        list(sampler)
    sampler.close()


# ---------------------------------------------------------------------------
# The worker loader (tests/test_grain_loader.py).
# ---------------------------------------------------------------------------

def test_grain_batches_shapes_and_count():
    ds = _ds(12, hw=(24, 32), dhw=(12, 16))
    batches = list(grain_batches(ds, 4, steps=3, seed=0))
    assert len(batches) == 3
    img, dep = batches[0]
    assert img.shape == (4, 24, 32, 3) and img.dtype == np.uint8
    assert dep.shape == (4, 12, 16) and dep.dtype == np.float32


def test_grain_shuffle_is_seeded_and_repeats_epochs():
    ds = _ds(16, hw=(8, 8), dhw=(4, 4))
    a = [b[0] for b in grain_batches(ds, 4, steps=10, seed=7)]
    b = [b[0] for b in grain_batches(ds, 4, steps=10, seed=7)]
    assert len(a) == 10
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = [b[0] for b in grain_batches(ds, 4, steps=10, seed=8)]
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    ids = _ids(ds, [(x, None) for x in a[:4]])
    assert sorted(ids) == list(range(16))  # an epoch without replacement


def test_grain_single_epoch_exhausts():
    ds = _ds(10, hw=(8, 8), dhw=(4, 4))
    batches = list(grain_batches(ds, 4, steps=None, shuffle=False))
    assert len(batches) == 2  # 10 // 4, remainder dropped
    np.testing.assert_array_equal(batches[1][0][0], ds[4][0])


def test_grain_workers_give_the_same_batches():
    ds = _ds(12, hw=(8, 8), dhw=(4, 4))
    inline = list(grain_batches(ds, 4, steps=5, seed=3))
    workers = list(grain_batches(ds, 4, steps=5, seed=3, num_workers=2))
    assert len(workers) == 5
    for (a, b), (c, d) in zip(inline, workers):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)

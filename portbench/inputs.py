"""The benchmark's inputs, made from the run's seed: scenes and weights.

Scenes: uint8 RGB frames and f32 depth maps at a dataset's raw shapes,
drawn in bulk on the host (the program's feeds take host rows). Each frame
is a coarse colour field of its own plus noise; each depth map a tilted
plane in log-depth of its own scale plus noise, clipped to the traffic's
`depth_m` range (values above 70 m are invalid to the loss); a share
`invalid_share` of the pixels is set to 0 (invalid).

Weights: one normal draw on the device for every kernel, split and scaled
per leaf (1/sqrt(fan_in) for convolution and dense kernels, 0.02 for a
position embedding); biases 0, norm scales 1.
"""

from __future__ import annotations

import math

import numpy as np

FINGERPRINT_PIXELS = 8


def seed64(seed: int) -> int:
    """Any whole number -> a non-negative seed below 2**63."""
    return int(seed) % (1 << 63)


class Scenes:
    """N scenes in host memory, with the loader protocol the program's
    datasets have (len, [i] -> (image, depth), name)."""

    def __init__(self, images, depths, name):
        self.images, self.depths, self.name = images, depths, name
        self._by_print = {self._print(images[i]): i
                          for i in range(len(images))}
        if len(self._by_print) != len(images):
            raise ValueError("two scenes share a fingerprint")

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.depths[i]

    @staticmethod
    def _print(row):
        return np.ascontiguousarray(row[0, :FINGERPRINT_PIXELS]).tobytes()

    def rows_of(self, first_pixels):
        """Scene index of each [B, 8, 3] uint8 block of first-row pixels;
        -1 where no scene starts so."""
        return [self._by_print.get(np.ascontiguousarray(r).tobytes(), -1)
                for r in first_pixels]


def _images(rng, n, hw, grid, noise_bits):
    """uint8 frames: a coarse colour field of each scene's own (levels 0 to
    255 - 2**noise_bits, on an n x grid lattice spread over the frame) plus
    uniform noise of 0 to 2**noise_bits - 1 levels."""
    span = 256 - (1 << noise_bits)
    coarse = (rng.random((n, grid[0], grid[1], 3), dtype=np.float32)
              * np.float32(span)).astype(np.uint8)
    rows = np.bincount(np.arange(hw[0]) * grid[0] // hw[0], minlength=grid[0])
    cols = np.bincount(np.arange(hw[1]) * grid[1] // hw[1], minlength=grid[1])
    images = np.repeat(np.repeat(coarse, rows, axis=1), cols, axis=2)
    noise = rng.integers(0, 256, images.shape, dtype=np.uint8)
    noise &= np.uint8((1 << noise_bits) - 1)
    images += noise
    return images


def _depths(rng, n, hw, scale_m, slope, noise, clip_m):
    """f32 depth maps: each scene a tilted plane in log-depth, its median
    log-uniform in `scale_m`, its slope along each axis uniform in
    +-slope over the frame, times a log-normal noise of sigma `noise`,
    clipped to `clip_m`."""
    lo, hi = np.log(scale_m[0]), np.log(scale_m[1])
    level = rng.uniform(lo, hi, (n, 1, 1)).astype(np.float32)
    tilt = rng.uniform(-slope, slope, (n, 2, 1, 1)).astype(np.float32)
    ys = (np.arange(hw[0], dtype=np.float32) / hw[0] - 0.5)[:, None]
    xs = (np.arange(hw[1], dtype=np.float32) / hw[1] - 0.5)[None, :]
    log_d = level + tilt[:, 0] * ys + tilt[:, 1] * xs
    log_d += rng.normal(0.0, noise, (n, hw[0], hw[1])).astype(np.float32)
    return np.clip(np.exp(log_d), clip_m[0], clip_m[1]).astype(np.float32)


def make_scenes(traffic: dict, seed: int) -> Scenes:
    """`traffic["scenes"]` scenes at the traffic's raw shapes; each scene
    has a structure of its own (image_grid, depth_scale_m, depth_slope),
    so that scenes differ in their loss and gradient."""
    rng = np.random.default_rng(seed64(seed))
    n = int(traffic["scenes"])
    images = _images(rng, n, traffic["image_hw"], traffic["image_grid"],
                     int(traffic["image_noise_bits"]))
    depths = _depths(rng, n, traffic["depth_hw"], traffic["depth_scale_m"],
                     float(traffic["depth_slope"]),
                     float(traffic["depth_noise"]), traffic["depth_m"])
    share = float(traffic.get("invalid_share", 0.0))
    if share:
        depths[rng.random(depths.shape, dtype=np.float32) < share] = 0.0
    return Scenes(images, depths, traffic["dataset"])


def _init_kind(name, shape):
    if name == "pos_embed":
        return "pos"
    if len(shape) >= 2:
        return "kernel"
    return "bias" if name.endswith("bias") else "scale"


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: f32 tensor on device} for {name: shape}."""
    import torch

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed64(seed) ^ 0x5EED)
    drawn = [k for k, s in shapes.items()
             if _init_kind(k, s) in ("kernel", "pos")]
    sizes = [math.prod(shapes[k]) for k in drawn]
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for k, chunk in zip(drawn, flat.split(sizes)):
        shape = shapes[k]
        std = (0.02 if _init_kind(k, shape) == "pos"
               else 1.0 / math.sqrt(math.prod(shape[1:])))
        out[k] = chunk.view(shape).mul_(std)
    for k, shape in shapes.items():
        if k not in out:
            fill = 0.0 if _init_kind(k, shape) == "bias" else 1.0
            out[k] = torch.full(shape, fill, device=device,
                                dtype=torch.float32)
    return {k: out[k] for k in shapes}

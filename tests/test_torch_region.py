"""The port's region-level selection against the JAX package's: the box
sum, the masks and the box budget, the host and device square NMS (box
sequences and counts equal on identical maps), the inverse crops, the
region pool's uint8 wire byte for byte, and the region pipeline from a
fixed scorer."""

import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data import transforms as pt_tr
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_torch.ops import region as pt_region
from deep_active_semantic_segmentation_torch.selection import (
    region_pipeline as pt_pipeline)
from deep_active_semantic_segmentation_tpu.data import pools as jx_pools
from deep_active_semantic_segmentation_tpu.data import transforms as jx_tr
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JxDirectoryStore)
from deep_active_semantic_segmentation_tpu.ops import region as jx_region
from deep_active_semantic_segmentation_tpu.selection import (
    region_pipeline as jx_pipeline)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, write_pool)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# box sum: the port sums rows then columns in f32 as the JAX package does,
# in another order inside each window; held to this share of the map's max
BOX_SUM_RTOL = 1e-6


def _fixture_maps():
    """The reference's NMS fixtures as (2, 512, 512) f32 maps: k/256 values,
    so every box sum of them is exact in f32 in any order."""
    return np.stack([np.asarray(Image.open(os.path.join(FIXTURES, f"nms_{i}.png")),
                                dtype=np.float32) / 256 for i in (0, 1)])


def _plateaued(seed: int, n: int = 4, shape=(12, 11), cell: int = 5,
               levels: int = 4, scale: float = 1.0) -> np.ndarray:
    """Blocky maps of few levels: plateaus with ties inside a map and
    across maps, the case where tie-breaking decides the boxes."""
    rng = np.random.RandomState(seed)
    low = rng.randint(0, levels, (n,) + shape).astype(np.float32) / (levels - 1)
    return (np.kron(low, np.ones((1, cell, cell), np.float32)) * scale).astype(np.float32)


# ------------------------------------------------------------- box sum, masks

@pytest.mark.parametrize("shape,kernel", [((2, 40, 37), 9), ((3, 65, 65), 17),
                                          ((1, 16, 23), 16), ((2, 9, 9), 1)])
def test_box_sum_valid_equals_jax(shape, kernel):
    maps = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    got = pt_region.box_sum_valid(torch.from_numpy(maps), kernel).numpy()
    ref = np.asarray(jx_region.box_sum_valid(jnp.asarray(maps), kernel))
    assert got.dtype == np.float32 and got.shape == ref.shape == (
        shape[0], shape[1] - kernel + 1, shape[2] - kernel + 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BOX_SUM_RTOL * ref.max())


def test_box_sum_of_the_fixtures_is_exact():
    maps = _fixture_maps()
    got = pt_region.box_sum_valid(torch.from_numpy(maps), 127).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jx_region.box_sum_valid(jnp.asarray(maps), 127)))


def test_masks_budget_and_dict_equal_jax():
    shape = (20, 23)
    for regions in ([], None, [(0, 0, 5, 5)], [(3, 4, 8, 8), (15, 18, 8, 8)],
                    [(19, 22, 9, 9), (0, 0, 20, 23)]):
        np.testing.assert_array_equal(pt_region.region_mask(shape, regions),
                                      jx_region.region_mask(shape, regions))
        got = pt_region.suppression_multiplier(shape, regions)
        ref = jx_region.suppression_multiplier(shape, regions)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    for args in ((5, 513, 129), (50, 513, 129), (60, 512, 129), (3, 33, 8)):
        assert (pt_region.num_requested_regions(*args)
                == jx_region.num_requested_regions(*args))
    images = [b"a", b"b", b"c"]
    selected = [[(1, 2, 8, 8)], [], [(0, 0, 8, 8), (9, 9, 8, 8)]]
    assert (pt_region.regions_to_dict(images, selected)
            == jx_region.regions_to_dict(images, selected))


# ----------------------------------------------------------------------- NMS

def _all_four(maps, region_size, count, max_count=None):
    """(regions, count) from the port's host and device NMS and the JAX
    package's, all on copies of the same f32 maps. The JAX device NMS gets
    a box buffer of ``max_count`` (default: the request) and the request as
    its ``limit``; the port's takes the request alone."""
    limit = int(np.ceil(count))
    max_count = max_count or limit
    host_maps = maps.copy()
    out = {"port_host": pt_region.square_nms(host_maps, region_size, limit),
           "jax_host": jx_region.square_nms(maps.copy(), region_size, limit)}
    t = torch.from_numpy(maps.copy())
    boxes, k = pt_region.square_nms_device(t, region_size, limit)
    # in place, as the host NMS: the same windows zeroed
    np.testing.assert_array_equal(t.numpy(), host_maps)
    assert boxes.shape == (limit, 3) and not boxes[int(k):].any()
    out["port_device"] = pt_region.device_boxes_to_regions(
        boxes.numpy(), int(k), maps.shape[0], region_size)
    jb, jk = jx_region.square_nms_device(
        jnp.asarray(maps), region_size=region_size, max_count=max_count,
        stop_threshold=0.01, limit=limit)
    out["jax_device"] = jx_region.device_boxes_to_regions(
        np.asarray(jb), int(jk), maps.shape[0], region_size)
    return out


def _assert_all_equal(out):
    ref = out["jax_host"]
    for name, got in out.items():
        assert got[1] == ref[1], (name, got[1], ref[1])
        assert got[0] == ref[0], name


def test_nms_on_the_reference_fixtures_equals_jax():
    box = np.asarray(jx_region.box_sum_valid(jnp.asarray(_fixture_maps()), 127))
    maps = ((box - box.min()) / (box.max() - box.min())).astype(np.float32)
    out = _all_four(maps, 127, (512 * 512) // 127 ** 2)
    _assert_all_equal(out)
    assert out["port_device"][1] == 10      # of 16 requested: the stop fired


@pytest.mark.parametrize("seed", range(4))
def test_nms_on_plateaued_stacks_equals_jax(seed):
    # odd seeds scale the maps under the 0.01 stop after a few boxes
    maps = _plateaued(seed, scale=0.02 if seed % 2 else 1.0)
    out = _all_four(maps, 13 if seed < 2 else 8, 25.5)
    _assert_all_equal(out)
    assert 1 <= out["port_device"][1] <= 26


@pytest.mark.parametrize("limit", [1, 5, 17])
def test_nms_with_a_limit_below_the_buffer_equals_jax(limit):
    maps = _plateaued(7, n=3, shape=(8, 9)) + 0.5       # never stops early
    out = _all_four(maps, 9, limit, max_count=64)
    _assert_all_equal(out)
    assert out["port_device"][1] == limit


def test_nms_on_uniform_maps_stops_after_one_box():
    maps = np.zeros((3, 20, 20), np.float32)        # what the guard makes
    out = _all_four(maps, 8, 10)
    _assert_all_equal(out)
    assert out["port_device"] == ([[(0, 0, 8, 8)], [], []], 1)


@pytest.mark.parametrize("request_", [pt_region.DONE_CHECK_EVERY - 1,
                                      pt_region.DONE_CHECK_EVERY,
                                      3 * pt_region.DONE_CHECK_EVERY + 1])
def test_nms_device_leaves_the_loop_once_stopped(request_):
    # maps under the 0.01 stop after one box, far fewer than requested:
    # the loop ends at a flag check, and the boxes past the count stay zero
    maps = _plateaued(11, n=5, shape=(6, 6), cell=4, scale=0.005)
    maps[2, 5, 7] = 1.0
    out = _all_four(maps, 4, request_)
    _assert_all_equal(out)
    assert out["port_device"][1] == 1


# -------------------------------------------------------------- inverse crops

@pytest.mark.parametrize("hw", [(40, 90), (90, 40), (37, 91), (64, 64), (101, 33)])
def test_inverse_crops_equal_jax(hw):
    rng = np.random.RandomState(hw[0] * hw[1])
    label = rng.randint(0, 19, hw).astype(np.uint8)
    for fn, size in (("invert_fix_scale_crop", 33), ("invert_fix_scale_crop", 17),
                     ("invert_scale_crop", 40), ("invert_scale_crop", 65)):
        # boxes at the corners and edges of the crop (and past them), the
        # whole crop, and one-pixel boxes
        boxes = [(0, 0, size, size), (0, 0, 1, 1), (size - 1, size - 1, 1, 1),
                 (size - 5, 0, 9, 9), (0, size - 5, 9, 9), (3, 7, 8, 5),
                 (size // 2, size // 3, 11, 13)]
        for box in boxes:
            got = np.full(hw, 255, np.uint8)
            ref = np.full(hw, 255, np.uint8)
            getattr(pt_tr, fn)(label, got, box, size)
            getattr(jx_tr, fn)(label, ref, box, size)
            np.testing.assert_array_equal(got, ref, err_msg=f"{fn} {size} {box}")


# ---------------------------------------------------------------- region pool

SIDE = 33


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("region"))
    store_dir = os.path.join(root, "train")
    keys = write_pool(DirectoryStore(store_dir, readonly=False), 8, seed=2)
    seed_dir = os.path.join(root, "seed_sets")
    os.makedirs(seed_dir)
    with open(os.path.join(seed_dir, "set_0.txt"), "w") as f:
        f.writelines(k.decode() + "\n" for k in keys[:3])
    return store_dir, seed_dir, keys


@pytest.mark.parametrize("family,base,crop", [("CITYSCAPES", SIDE, SIDE),
                                              ("CITYSCAPES", 40, 17),
                                              ("PASCAL", 40, -1)])
def test_region_pool_equals_jax_byte_for_byte(seeded, family, base, crop):
    store_dir, seed_dir, keys = seeded
    args = (base, crop, "train", "set_0.txt", seed_dir)
    jp = jx_pools.ActiveRegionPool(getattr(jx_pools, family),
                                   JxDirectoryStore(store_dir), *args,
                                   device_normalize=True)
    pp = pt_pools.ActiveRegionPool(getattr(pt_pools, family),
                                   DirectoryStore(store_dir), *args,
                                   rng=random.Random(5))
    side = base if family == "PASCAL" else crop

    def state(p):
        return (list(p.current_image_paths), len(p),
                list(p.current_paths_to_regions_map.items()),
                p.labeled_pixel_count, p.get_fraction_of_labeled_data(),
                p.get_next_est_fraction_of_labeled_data(2),
                p.get_existing_region_maps())

    assert state(pp) == state(jp)
    assert pp.current_paths_to_regions_map[keys[0]] == [(0, 0, side, side)]
    # new boxes on a labeled image and on two new ones, at the edges
    new = {keys[0]: [(side - 4, side - 4, 8, 8)],
           keys[5]: [(0, 0, 8, 8), (side // 2, 1, 8, 8)],
           keys[3]: [(2, side - 3, 8, 8)]}
    for pool in (jp, pp):
        pool.expand_training_set({k: list(v) for k, v in new.items()}, 4 * 64)
    assert state(pp) == state(jp) and len(pp) == 5
    for pool in (jp, pp):
        pool.make_dataset_multiple_of_batchsize(3)
    assert state(pp) == state(jp) and len(pp) == 6

    random.seed(5)       # the JAX pool's transforms draw from module random
    items = [(pp.get_item(i), jp.get_item(i)) for i in range(len(pp))]
    for a, b in items:
        for k in ("image", "label"):
            assert a[k].dtype == b[k].dtype == np.uint8
            np.testing.assert_array_equal(a[k], b[k])
    # the new images carry both labeled pixels and the 255 fill
    new_label = items[4][0]["label"]
    assert (new_label != 255).any() and (new_label == 255).any()
    for pool in (jp, pp):
        pool.reset_dataset()
    assert state(pp) == state(jp) and len(pp) == 5


# ------------------------------------------------------------ region pipeline

class _Loader:
    """Batches of ``batch`` rows, the last one padded (nvalid < batch)."""

    def __init__(self, n, batch):
        self.n, self.batch = n, batch

    def __iter__(self):
        for start in range(0, self.n, self.batch):
            yield {"nvalid": min(self.batch, self.n - start), "index": start // self.batch}


@pytest.mark.parametrize("uniform", [False, True])
def test_region_pipeline_equals_jax_from_a_fixed_scorer(uniform):
    """Both pipelines get identical score maps (k/256 values, so the box
    sums are exact in f32 in either order) with labeled boxes to suppress,
    one in the padded trailing batch; or a uniform pool, which takes one
    box and stops."""
    n, batch, hw, region_size = 7, 3, (40, 36), 9
    rng = np.random.RandomState(4)
    maps = (rng.randint(0, 256, (3 * batch,) + hw) / 256).astype(np.float32)
    images = [f"img_{i}".encode() for i in range(n)]
    existing = [[], [(0, 0, 40, 36)], [(5, 5, 9, 9), (30, 20, 9, 9)], [], [],
                [], [(10, 0, 9, 9)]]
    if uniform:          # a uniform pool: the normalization's guard
        maps[:] = 0.5
        existing = [[] for _ in images]

    def scorer(to):
        return lambda b: to(maps[b["index"] * batch:(b["index"] + 1) * batch])

    got = pt_pipeline.create_region_maps_from_scorer(
        scorer(torch.from_numpy), _Loader(n, batch), images, existing,
        region_size, 2, 36)
    ref = jx_pipeline.create_region_maps_from_scorer(
        scorer(jnp.asarray), _Loader(n, batch), images, existing,
        region_size, 2, 36)
    assert got == ref
    assert got[1] == (1 if uniform else int(np.ceil(2 * 36 * 36 / 81)))

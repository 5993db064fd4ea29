"""The port's native host resampler (data/native.py): byte-equal to PIL
(its plain version, ``transforms.imresize_plain``) and to the JAX
package's binding of the same C++ source, in the full and the crop-window
form; built under a hash of the source and flags, once across processes,
and a failed build raises with the compiler's message. Then the Loaders:
every port Loader path resizes through it (PIL is never called), and the
passive pools' batches are byte-equal to the JAX Loader's.

Every comparison is exact: the resampler reproduces PIL's fixed-point
arithmetic."""

import os
import random
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
from PIL import Image

from deep_active_semantic_segmentation_torch.data import native as pt_native
from deep_active_semantic_segmentation_torch.data import pools as pt_pools
from deep_active_semantic_segmentation_torch.data import transforms as pt_tr
from deep_active_semantic_segmentation_torch.data.loader import (
    Loader as PtLoader, PathsLoader as PtPathsLoader)
from deep_active_semantic_segmentation_torch.data.store import DirectoryStore
from deep_active_semantic_segmentation_tpu.data import native as jx_native
from deep_active_semantic_segmentation_tpu.data import pools as jx_pools
from deep_active_semantic_segmentation_tpu.data.loader import Loader as JxLoader
from deep_active_semantic_segmentation_tpu.data.store import (
    DirectoryStore as JxDirectoryStore)
from torch_port_helpers import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, write_pool)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# how long to wait for another process's build of the JAX package's
# native/libdass_native.so (a g++ -O3 build takes a few seconds)
JAX_BUILD_WAIT_S = 240

# (h, w, oh, ow): down, up, odd and the Cityscapes record to crop 513
SHAPES = [(100, 150, 65, 98), (40, 60, 80, 121), (7, 13, 5, 9),
          (256, 512, 129, 258)]


@pytest.fixture(scope="module")
def jax_binding():
    """The JAX package's binding of the same source, loaded. Its
    ``get_lib`` builds ``native/libdass_native.so`` in place on first use
    under a thread lock only, and caches a failed load for the life of the
    process; so while another test process (``tests/test_native.py`` under
    xdist) is writing that file, a load fails once and for good. Try
    again from a fresh state until a load succeeds or the deadline
    passes: a build that really fails still leaves ``resize_u8``
    returning None."""
    deadline = time.monotonic() + JAX_BUILD_WAIT_S
    while True:
        jx_native._tried, jx_native._lib = False, None
        if jx_native.get_lib() is not None or time.monotonic() > deadline:
            return jx_native
        time.sleep(0.5)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_resize_equals_pil_and_the_jax_binding(jax_binding, shape, channels, interp):
    h, w, oh, ow = shape
    rng = np.random.RandomState(h + w + channels)
    x = rng.randint(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 1:
        x = x[..., 0]
    got = pt_tr.imresize(x, (oh, ow), interp)
    np.testing.assert_array_equal(got, pt_tr.imresize_plain(x, (oh, ow), interp))
    ref = jax_binding.resize_u8(x, oh, ow, interp)
    assert ref is not None   # the JAX package's own build of the same source
    np.testing.assert_array_equal(got, ref)
    # a window of the resize, computed alone
    x0, y0, cw, ch = ow // 4, oh // 3, ow // 2, oh // 2
    win = pt_native.resize_u8_window(x, oh, ow, x0, y0, cw, ch, interp)
    np.testing.assert_array_equal(win, got[y0:y0 + ch, x0:x0 + cw])
    np.testing.assert_array_equal(
        win, jax_binding.resize_u8_window(x, oh, ow, x0, y0, cw, ch, interp))


def test_crop_transforms_equal_pil_resize_then_crop():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (90, 140, 3), dtype=np.uint8)
    lab = rng.randint(0, 19, (90, 140)).astype(np.uint8)
    for crop in (33, 65):
        out = pt_tr.FixScaleCrop(crop)({"image": img, "label": lab})
        oh, ow = pt_tr._short_side_dims(140, 90, crop)
        x1, y1 = pt_tr._center_crop_origin(oh, ow, crop)
        for key, plane, interp in (("image", img, "bilinear"),
                                   ("label", lab, "nearest")):
            ref = pt_tr.imresize_plain(plane, (oh, ow), interp)
            np.testing.assert_array_equal(out[key], ref[y1:y1 + crop, x1:x1 + crop])
        np.testing.assert_array_equal(pt_tr.FixScaleCropImageOnly(crop)(img),
                                      out["image"])


def test_inputs_are_checked():
    x = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        pt_native.resize_u8_window(x, 4, 4, 2, 0, 3, 4)
    with pytest.raises(ValueError, match="bicubic"):
        pt_tr.imresize(x, (4, 4), "bicubic")
    with pytest.raises(ValueError, match="uint8"):
        pt_native.resize_u8(x.astype(np.float32), 4, 4)
    # imresize clip-casts other dtypes first, as old scipy's path did
    f = np.linspace(-50, 300, 64, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(pt_tr.imresize(f, (5, 5)),
                                  pt_tr.imresize_plain(f, (5, 5)))
    with pytest.raises(ValueError):
        pt_native.set_num_threads(0)


_BUILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    from deep_active_semantic_segmentation_torch.data import native
    native.BUILD_DIR, native.SOURCE = Path(sys.argv[1]), Path(sys.argv[2])
    x = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    print(native.library_path().name, native.resize_u8(x, 2, 2).sum())
""")


def test_builds_once_across_processes_and_names_the_library_by_hash(tmp_path):
    """Four processes build one edited copy of the source at once: one
    library, named by the hash of source and flags, no temporary file
    left, and every process loads and runs it."""
    src = tmp_path / "dass_native.cpp"
    src.write_text(pt_native.SOURCE.read_text() + "\n// an edited copy\n")
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(build_dir), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o.split()[0] for o, _ in outs}
    assert len(names) == 1 and len({o.split()[1] for o, _ in outs}) == 1
    libs = sorted(p.name for p in build_dir.iterdir() if p.suffix == ".so")
    assert libs == sorted(names)
    assert not [p for p in build_dir.iterdir() if p.name.endswith(".tmp")]
    # the edited copy's name differs from the repo source's
    assert libs[0] != pt_native.library_path().name
    assert pt_native.library_path().name.startswith("libdass_native-")


def test_the_library_name_carries_the_host_cpu(tmp_path, monkeypatch):
    """A library built for one CPU is never loaded on another: with the
    host's CPU identity patched to another value, ``library_path()``
    changes, and loading builds that name instead of opening the file
    under the old one (here not a library at all, so opening it would
    raise)."""
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path)
    here = pt_native.library_path()
    assert pt_native.library_path() == here   # the identity is read once
    assert "-march=" in pt_native.host_cpu()
    here.write_bytes(b"built for another CPU")
    monkeypatch.setattr(pt_native, "_host_cpu",
                        pt_native.host_cpu().replace("-march=", "-march=other"))
    other = pt_native.library_path()
    assert other != here and other.name.startswith("libdass_native-")
    monkeypatch.setattr(pt_native, "_lib", None)
    lib = pt_native.get_lib()
    assert lib._name == str(other) and other.exists()
    assert here.read_bytes() == b"built for another CPU"
    x = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    np.testing.assert_array_equal(pt_native.resize_u8(x, 2, 2),
                                  pt_tr.imresize_plain(x, (2, 2)))


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("extern \"C\" void resize_bilinear_u8_window( {\n")
    monkeypatch.setattr(pt_native, "SOURCE", src)
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ exited.*error"):
        pt_native.build()
    assert not list((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------------ loaders

@pytest.fixture
def no_pil_resize(monkeypatch):
    """PIL's resize raises: whatever runs inside resizes natively."""
    def refuse(*args, **kwargs):
        raise AssertionError("PIL resize called")

    monkeypatch.setattr(Image.Image, "resize", refuse)


def test_every_port_loader_path_resizes_natively(tmp_path, no_pil_resize):
    write_pool(DirectoryStore(str(tmp_path), readonly=False), 3, seed=2)
    store = DirectoryStore(str(tmp_path))
    rng = random.Random(0)
    for pool in (pt_pools.PassivePool(pt_pools.CITYSCAPES, store, 40, 33, "train", rng=rng),
                 pt_pools.PassivePool(pt_pools.PASCAL, store, 32, -1, "val", rng=rng),
                 pt_pools.PassivePool(pt_pools.CITYSCAPES, store, 33, -1, "val", rng=rng),
                 pt_pools.ActiveImagePool(pt_pools.CITYSCAPES, store, 40, 33, "train",
                                          rng=rng),
                 pt_pools.ActiveRegionPool(pt_pools.PASCAL, store, 32, -1, "train",
                                           rng=rng)):
        batches = list(PtLoader(pool, 2))
        assert batches and batches[0]["image"].dtype == np.uint8
    keys = list(store.keys())
    for crop in (33, -1):
        assert list(PtPathsLoader(store, keys, crop, 2, include_labels=True))


@pytest.mark.parametrize("family,crop", [("CITYSCAPES", 33), ("CITYSCAPES", -1),
                                        ("PASCAL", -1)])
def test_passive_loader_batches_equal_jax_byte_for_byte(tmp_path, family, crop):
    """Two epochs of the passive train pool's shuffled loader (5 records,
    batch 2) with the JAX package's module-level ``random`` seeded as the
    port's ``random.Random``, and the val loader."""
    write_pool(DirectoryStore(str(tmp_path), readonly=False), 5, seed=4)
    base = 40 if crop != -1 else 32   # the letterbox needs an even base
    for split, shuffle in (("train", True), ("val", False)):
        jpool = jx_pools.PassivePool(getattr(jx_pools, family),
                                     JxDirectoryStore(str(tmp_path)), base, crop,
                                     split, device_normalize=True)
        ppool = pt_pools.PassivePool(getattr(pt_pools, family),
                                     DirectoryStore(str(tmp_path)), base, crop,
                                     split, rng=random.Random(11))
        for pool in (jpool, ppool):
            pool.make_dataset_multiple_of_batchsize(2)
        assert len(jpool) == len(ppool) == 6
        jl = JxLoader(jpool, 2, shuffle=shuffle, seed=9)
        pl = PtLoader(ppool, 2, shuffle=shuffle, seed=9)
        random.seed(11)
        ref = [b for _ in range(2) for b in jl]
        got = [b for _ in range(2) for b in pl]
        assert len(got) == len(ref) == 6
        for a, b in zip(got, ref, strict=True):
            for k in ("image", "label"):
                assert a[k].dtype == b[k].dtype == np.uint8
                np.testing.assert_array_equal(a[k], b[k])
        for pool in (jpool, ppool):
            pool.reset_dataset()
        assert len(jpool) == len(ppool) == 5


def test_concurrent_calls_from_many_threads_stay_exact():
    """Sixteen threads (more than the cores) resize at once, each on its
    own OpenMP team, with a short switch interval: every result is PIL's."""
    import threading

    rng = np.random.RandomState(5)
    images = [rng.randint(0, 256, (60 + i, 90 + i, 3), dtype=np.uint8) for i in range(16)]
    want = [pt_tr.imresize_plain(x, (37, 55)) for x in images]
    got, errors = [None] * 16, []

    def work(i):
        try:
            for _ in range(20):
                got[i] = pt_tr.imresize(images[i], (37, 55))
                if not np.array_equal(got[i], want[i]):
                    errors.append(i)
        except Exception as e:   # recorded, asserted below
            errors.append(repr(e))

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

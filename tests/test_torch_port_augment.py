"""The port's train-time augmentation against the JAX package's on the CPU:
`data.augment.train_augment`, the host colour jitter of `native`, the
augment branch of `MP100Dataset` and augmented `episode_batches`.

Both packages augment through cv2 and the same C++ jitter built with the
same g++ flags, so at one seed the images must be byte-equal and the
keypoints equal (held within 1e-9). The numpy jitter (`CAPE_NATIVE=0`) is
the C++ op's plain version: its float32 pairwise mean may differ from the
C++ exact mean by one output level.
"""

import sys

import numpy as np
import pytest

from cape_tpu import native as jax_native
from cape_tpu.data import augment as jax_augment
from cape_tpu.data import episodic as jax_episodic
from cape_tpu.data import mp100 as jax_mp100
from cape_tpu.data.tokenizer import DiscreteTokenizer as JaxTok

from cape_tpu_torch import native as port_native
from cape_tpu_torch.data import augment as port_augment
from cape_tpu_torch.data import episodic as port_episodic
from cape_tpu_torch.data import mp100 as port_mp100
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.data.tokenizer import DiscreteTokenizer as PortTok

from test_torch_port_util import few_torch_threads  # noqa: F401

#: seeds of `train_augment`; `test_seeds_cover_every_branch` holds that
#: they reach the affine, the jitter and each of the three noise/blur ops,
#: both motion-blur directions included (the flip, p=0.5, needs no proof)
SEEDS = tuple(range(48))


def _crop(seed, h=37, w=53):
    rng = np.random.default_rng(1000 + seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    kpts = rng.uniform(-2, [w + 2, h + 2], (7, 2))
    return img, kpts


@pytest.fixture(scope="module")
def jax_native_built():
    assert jax_native.available(), "the JAX package's C++ jitter did not build"


@pytest.mark.parametrize("chunk", range(4))
def test_train_augment_matches_jax(chunk, jax_native_built):
    for seed in SEEDS[chunk::4]:
        img, kpts = _crop(seed)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        want_img, want_k = jax_augment.train_augment(img, kpts, 24, ra)
        got_img, got_k = port_augment.train_augment(img, kpts, 24, rb)
        assert got_img.dtype == np.uint8 and got_img.shape == (24, 24, 3)
        assert got_img.tobytes() == want_img.tobytes(), seed
        np.testing.assert_allclose(got_k, want_k, rtol=0, atol=1e-9)
        assert ra.bit_generator.state == rb.bit_generator.state, seed


def test_seeds_cover_every_branch(monkeypatch):
    hits = {}

    def count(name, fn):
        def wrapped(*a, **k):
            hits[name] = hits.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(port_augment, name, wrapped)

    for name in ("_apply_affine", "_hue_shift", "_gauss_noise",
                 "_gaussian_blur", "_motion_blur"):
        count(name, getattr(port_augment, name))
    directions = set()
    orig_filter = port_augment._cv2().filter2D

    class Cv2:
        def __getattr__(self, k):
            return getattr(orig_cv2, k)

        def filter2D(self, img, depth, kernel):
            directions.add("row" if kernel[kernel.shape[0] // 2].all()
                           else "col")
            return orig_filter(img, depth, kernel)

    orig_cv2 = port_augment._cv2()
    monkeypatch.setattr(port_augment, "_cv2", lambda: Cv2())
    for seed in SEEDS:
        img, kpts = _crop(seed)
        port_augment.train_augment(img, kpts, 24, np.random.default_rng(seed))
    assert all(hits.get(k, 0) >= 2 for k in (
        "_apply_affine", "_hue_shift", "_gauss_noise", "_gaussian_blur",
        "_motion_blur")), hits
    assert directions == {"row", "col"}


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (64, 48), (129, 77)])
def test_native_jitter_matches_jax_native(shape, jax_native_built):
    """Byte-equal to the JAX package's C++ op, and within one level of the
    numpy plain version (the mean's summation order)."""
    rng = np.random.default_rng(shape[0])
    for _ in range(4):
        img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        b, c, s = (float(v) for v in rng.uniform(0.7, 1.3, 3))
        got = port_native.fused_bcs(img, b, c, s)
        assert got.tobytes() == jax_native.fused_bcs(img, b, c, s).tobytes()
        plain = port_native.fused_bcs_numpy(img, b, c, s)
        assert np.abs(got.astype(int) - plain.astype(int)).max() <= 1


def test_native_jitter_noncontiguous_and_bad_input():
    img = np.random.default_rng(3).integers(0, 256, (20, 30, 3),
                                            dtype=np.uint8)
    view = img[:, ::-1]
    np.testing.assert_array_equal(
        port_native.fused_bcs(view, 1.1, 0.9, 1.2),
        port_native.fused_bcs(np.ascontiguousarray(view), 1.1, 0.9, 1.2))
    with pytest.raises(ValueError, match="uint8"):
        port_native.fused_bcs(img.astype(np.float32), 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="uint8"):
        port_native.fused_bcs_numpy(img[..., :2], 1.0, 1.0, 1.0)


def test_cape_native_0_takes_the_numpy_version(monkeypatch):
    """`CAPE_NATIVE=0` runs `fused_bcs_numpy`, which is the JAX package's
    numpy jitter: byte-equal to it with the JAX C++ op switched off."""
    monkeypatch.setenv("CAPE_NATIVE", "0")
    monkeypatch.setattr(port_native, "fused_bcs", None)  # never called
    monkeypatch.setattr(jax_native, "fused_bcs", lambda *a: None)
    for seed in range(6):
        img, _ = _crop(seed, 40, 30)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_augment._color_jitter(img, ra)
        got = port_augment._color_jitter(img, rb)
        assert got.tobytes() == want.tobytes()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """g++'s errors surface; nothing drops to numpy in silence."""
    bad = tmp_path / "hostops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(port_native, "SRC", bad)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_native, "_lib", None)
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        port_native.fused_bcs(img, 1.0, 1.0, 1.0)
    monkeypatch.setenv("PATH", str(tmp_path))   # no g++ at all
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        port_native.fused_bcs(img, 1.0, 1.0, 1.0)


def test_train_augment_without_cv2_raises(monkeypatch):
    img, kpts = _crop(0)
    rng = np.random.default_rng(0)
    before = rng.bit_generator.state
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="requires cv2"):
        port_augment.train_augment(img, kpts, 24, rng)
    assert rng.bit_generator.state == before      # nothing drawn


# -- dataset and batches -------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_mp100(str(tmp_path_factory.mktemp("aug_tree")),
                                num_categories=6, images_per_category=6,
                                keypoint_range=(4, 9))


def _datasets(tree, size=48):
    jd = jax_mp100.MP100Dataset(tree["img_dir"], tree["train_ann"],
                                JaxTok(10, 24), image_size=size,
                                split="train", uint8_images=True)
    pd = port_mp100.MP100Dataset(tree["img_dir"], tree["train_ann"],
                                 PortTok(10, 24), image_size=size,
                                 split="train", uint8_images=True)
    assert jd.augment and pd.augment
    return jd, pd


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f" and a.ndim == 2 and a.shape[-1] == 2:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        else:
            assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_dataset_augmented_records_match_jax(tree, jax_native_built):
    """Records with augmentation on equal the JAX package's; the crop
    cache's keypoints stay pristine and the record cache stays empty."""
    jd, pd = _datasets(tree)
    for i in range(len(pd)):
        for seed in (i, 100 + i):
            want = jd.get_record(i, np.random.default_rng(seed))
            got = pd.get_record(i, np.random.default_rng(seed))
            _same(got, want)
    again = pd.get_record(0, np.random.default_rng(0))
    _same(again, jd.get_record(0, np.random.default_rng(0)))
    crop_k = pd._load_crop(pd.ids[0])[1]
    assert np.array_equal(crop_k, jd._load_crop(jd.ids[0])[1])
    assert not pd._record_cache.d


@pytest.mark.parametrize("threads", [1, 4])
def test_augmented_episode_batches_match_jax(tree, threads, jax_native_built):
    """Byte-equal batches with augmentation on, each episode on its own
    child generator drawn in order from the parent stream, and the parent
    stream left in the same state."""
    jd, pd = _datasets(tree)
    split = tree["split_file"]
    js = jax_episodic.EpisodicSampler(jd, split, "train", num_queries=2)
    ps = port_episodic.EpisodicSampler(pd, split, "train", num_queries=2)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    args = (2, 3, 48, 12, 16)
    want = list(jax_episodic.episode_batches(jd, js, *args, ra,
                                             num_threads=threads))
    got = list(port_episodic.episode_batches(pd, ps, *args, rb,
                                             num_threads=threads))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    assert ra.bit_generator.state == rb.bit_generator.state
    one = list(port_episodic.episode_batches(
        pd, ps, *args, np.random.default_rng(7), num_threads=1))
    for g, w in zip(got, one):
        _same(g, w)

"""The port's data pipeline against the JAX package's on the CPU: the
synthetic fixture, the image routes, `MP100Dataset`, the episodic sampler
and batches, the split files, prefetch.

Where cv2 is installed both packages resize through cv2, so records
and batches must be byte-equal at the same seed. The port's cv2-free resize
is held to cv2 within 1 level (it rounds a float bilinear result where cv2
rounds in fixed point); its own PNG reader to PIL bit for bit. A subprocess
with neither cv2 nor PIL builds the fixture and a batch through the port's
own routes.
"""

import json
import os
import struct
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from cape_tpu.config import tiny_test_config as jax_tiny_config
from cape_tpu.data import builder as jax_builder
from cape_tpu.data import coco as jax_coco
from cape_tpu.data import episodic as jax_episodic
from cape_tpu.data import mp100 as jax_mp100
from cape_tpu.data import prefetch as jax_prefetch
from cape_tpu.data import splits as jax_splits
from cape_tpu.data.synthetic import make_synthetic_mp100 as jax_make

from cape_tpu_torch.config import tiny_test_config as port_tiny_config
from cape_tpu_torch.data import builder as port_builder
from cape_tpu_torch.data import coco as port_coco
from cape_tpu_torch.data import episodic as port_episodic
from cape_tpu_torch.data import image as port_image
from cape_tpu_torch.data import mp100 as port_mp100
from cape_tpu_torch.data import prefetch as port_prefetch
from cape_tpu_torch.data import splits as port_splits
from cape_tpu_torch.data.augment import resize_with_keypoints
from cape_tpu_torch.data.synthetic import make_synthetic_mp100 as port_make

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: fixture arguments: five folds (so every split helper has its files) and
#: categories of 7 images (5-shot episodes with a query)
FIXTURE = dict(num_categories=6, images_per_category=7, keypoint_range=(4, 8),
               num_splits=5)
#: a second fixture through the rendered-marker branch
LEARNABLE = dict(num_categories=5, images_per_category=3, learnable=True,
                 marker_style="uniform", layout_jitter=0.05, seed=3)

JAX = (jax_builder, jax_episodic, jax_tiny_config)
PORT = (port_builder, port_episodic, port_tiny_config)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """name -> (JAX fixture paths, port fixture paths)."""
    root = tmp_path_factory.mktemp("mp100")
    out = {}
    for name, kw in (("plain", FIXTURE), ("learnable", LEARNABLE)):
        out[name] = (jax_make(str(root / f"{name}_jax"), **kw),
                     port_make(str(root / f"{name}_port"), **kw))
    return out


@pytest.fixture(scope="module")
def paths(trees):
    """The port-written plain fixture: both packages read it."""
    return trees["plain"][1]


def _cfg(lib, paths, **kw):
    return lib[2](dataset_root=paths["root"],
                  category_split_file=paths["split_file"], **kw)


def _dataset(lib, paths, split="val", **kw):
    return lib[0].build_mp100_cape(split, _cfg(lib, paths, **kw))


def _sampler(lib, ds, paths, split="val", **kw):
    return lib[1].EpisodicSampler(ds, paths["split_file"], split, **kw)


def assert_tree_bytes_equal(got, want, path=""):
    """Same keys, dtypes, shapes and bytes at every leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_bytes_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), path


def png_filters(path):
    """The filter types of a PNG's rows."""
    with open(path, "rb") as f:
        blob = f.read()
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, body = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, _, ctype = header[:4]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, w * ch + 1)[:, 0].tolist())


# -- the fixture -----------------------------------------------------------------
@pytest.mark.parametrize("name", ["plain", "learnable"])
def test_fixture_matches_jax(trees, name):
    """The same annotation JSONs, split file and image pixels."""
    jp, pp = trees[name]
    for key in ("train_ann", "val_ann", "test_ann", "split_file"):
        with open(jp[key]) as a, open(pp[key]) as b:
            assert a.read() == b.read(), key
    for split in range(2, FIXTURE["num_splits"] + 1 if name == "plain" else 1):
        for s in ("train", "val", "test"):
            f = f"annotations/mp100_split{split}_{s}.json"
            with open(os.path.join(jp["root"], f)) as a, \
                    open(os.path.join(pp["root"], f)) as b:
                assert a.read() == b.read(), f
    files = sorted(os.listdir(jp["img_dir"]))
    assert files == sorted(os.listdir(pp["img_dir"])) and files
    for f in files:
        a = np.asarray(Image.open(os.path.join(jp["img_dir"], f)))
        b = np.asarray(Image.open(os.path.join(pp["img_dir"], f)))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert png_filters(os.path.join(pp["img_dir"], f)) == {0}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_own_png_reader_matches_pil_on_fixture(trees, writer):
    """The port's reader on the PIL-written (JAX) and the port-written
    fixture images: PIL's bytes."""
    p = trees["plain"][0 if writer == "jax" else 1]
    for f in sorted(os.listdir(p["img_dir"])):
        path = os.path.join(p["img_dir"], f)
        want = np.asarray(Image.open(path).convert("RGB"))
        got = port_image.read_png(path)
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes(), f


def _all_filter_image(rng, ch, w):
    """Rows that lead PIL's optimising encoder to each of its five filters:
    noise, a row that is the running average of its left neighbour and the
    row above (Average), ramps (Sub, Paeth), flat and repeated rows (None,
    Up)."""
    above = rng.integers(0, 256, (w, ch))
    avg = np.zeros((w, ch), np.int64)
    for x in range(w):
        avg[x] = ((avg[x - 1] if x else 0) + above[x]) // 2
    yy, xx = np.mgrid[0:8, 0:w]
    ramp = ((xx * 3 + yy * 5) % 256)[..., None].repeat(ch, 2)
    rows = np.concatenate([np.stack([above, avg] * 3),
                           rng.integers(0, 256, (6, w, ch)), ramp,
                           np.full((3, w, ch), 7)]).astype(np.uint8)
    return rows[..., 0] if ch == 1 else rows


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_own_png_reader_matches_pil(tmp_path, mode):
    """PIL-written PNGs of odd widths that carry all five filter types
    together: the port's reader returns PIL's RGB bytes."""
    rng = np.random.default_rng(7)
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    seen = set()
    for w in (1, 3, 17, 57):
        path = str(tmp_path / f"{mode}_{w}.png")
        Image.fromarray(_all_filter_image(rng, ch, w), mode=mode).save(
            path, optimize=True)
        seen |= png_filters(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        got = port_image.read_png(path)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), w
    assert seen == {0, 1, 2, 3, 4}


def test_png_writer_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((1, 1, 3), (9, 4, 3), (3, 11, 3)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        path = str(tmp_path / f"w{shape[0]}_{shape[1]}.png")
        port_image.write_png(path, a)
        assert np.array_equal(np.asarray(Image.open(path)), a)
        assert np.array_equal(port_image.read_png(path), a)
    for bad in (a.astype(np.float32), a[..., 0]):
        with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
            port_image.write_png(str(tmp_path / "f.png"), bad)


@pytest.mark.parametrize("src,dst", [((96, 128), (512, 512)),
                                     ((81, 113), (512, 512)),
                                     ((700, 900), (512, 512)),
                                     ((600, 500), (64, 64)),
                                     ((37, 53), (41, 29))])
def test_bilinear_resize_within_one_level_of_cv2(monkeypatch, src, dst):
    """The cv2-free resize against `cv2.resize(INTER_LINEAR)`: at most 1
    level apart, on upscale and downscale sizes, with the same keypoints."""
    import cv2

    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    kpts = rng.uniform(0, 1, (6, 2)) * [src[1], src[0]]
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = port_image.resize_bilinear(img, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # through `resize_with_keypoints`, on each route; non-square targets
    # go through `resize` directly
    if dst[0] == dst[1]:
        _, k_cv2 = resize_with_keypoints(img, kpts, dst[0])
        monkeypatch.setattr(port_image, "cv2", None)
        out, k_own = resize_with_keypoints(img, kpts, dst[0])
        np.testing.assert_array_equal(out, got)
        np.testing.assert_array_equal(k_own, k_cv2)
    else:
        monkeypatch.setattr(port_image, "cv2", None)
        np.testing.assert_array_equal(port_image.resize(img, dst), got)


# -- dataset ---------------------------------------------------------------------
def test_coco_index_matches_jax(paths):
    a = jax_coco.COCOIndex(paths["val_ann"])
    b = port_coco.COCOIndex(paths["val_ann"])
    assert a.get_img_ids() == b.get_img_ids()
    for c in a.cats:
        assert a.category_skeleton(c) == b.category_skeleton(c)
        assert a.category_num_keypoints(c) == b.category_num_keypoints(c)
    # 0-indexed skeletons pass through, unknown categories are empty
    doc = {"images": [], "annotations": [],
           "categories": [{"id": 1, "skeleton": [[0, 1], [1, 2]],
                           "keypoints": ["a", "b", "c"]}]}
    for idx in (jax_coco.COCOIndex(doc), port_coco.COCOIndex(doc)):
        assert idx.category_skeleton(1) == [[0, 1], [1, 2]]
        assert idx.category_skeleton(9) == []
        assert idx.category_num_keypoints(9) is None


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("split", ["val", "test"])
def test_get_record_matches_jax(paths, split, uint8):
    """Every record of the split: byte-equal images, equal keypoints,
    visibility, bbox dims, tokenized targets and metadata; the record
    cache returns the same."""
    kw = dict(uint8_transfer=uint8, image_norm=not uint8)
    jd, pd = _dataset(JAX, paths, split, **kw), _dataset(PORT, paths, split, **kw)
    assert jd.ids == pd.ids and len(pd) > 0
    for i in range(len(pd)):
        for _ in range(2):
            a = jd.get_record(i, np.random.default_rng(i))
            b = pd.get_record(i, np.random.default_rng(i))
            assert set(a) == set(b)
            for k in ("category_id", "skeleton", "bbox_width", "bbox_height",
                      "num_keypoints", "image_id"):
                assert a[k] == b[k], k
            for k in ("image", "keypoints", "visibility"):
                assert_tree_bytes_equal(b[k], a[k], k)
            assert_tree_bytes_equal(b["seq_data"], a["seq_data"], "seq_data")
    assert port_mp100.image_to_uint8(b["image"]).tobytes() == \
        jax_mp100.image_to_uint8(a["image"]).tobytes()


def test_missing_and_invalid_images_raise_image_not_found(paths, tmp_path):
    """A missing file and an annotation without visible keypoints raise
    `ImageNotFoundError` (the sampler resamples on it), as in the JAX
    package; a clamped-empty bbox too."""
    with open(paths["val_ann"]) as f:
        doc = json.load(f)
    img0, ann0 = doc["images"][0], doc["annotations"][0]
    doc["images"] = [img0, dict(img0, id=999, file_name="missing.png"),
                     dict(img0, id=1000), dict(img0, id=1001)]
    doc["annotations"] = [
        ann0, dict(ann0, id=998, image_id=999),
        dict(ann0, id=997, image_id=1000,
             keypoints=[0.0 if j % 3 == 2 else v
                        for j, v in enumerate(ann0["keypoints"])]),
        dict(ann0, id=996, image_id=1001, bbox=[500, 500, 10, 10])]
    for lib, tok in ((jax_mp100, jax_builder.DiscreteTokenizer(10, 24)),
                     (port_mp100, port_builder.DiscreteTokenizer(10, 24))):
        ds = lib.MP100Dataset(paths["img_dir"], doc, tok, 64, split="val")
        ds.get_record(0)
        for i in (1, 2, 3):
            with pytest.raises(lib.ImageNotFoundError):
                ds.get_record(i)


def test_lru_bytes_matches_jax():
    """The same evictions under the same puts and gets."""
    a, b = jax_mp100._LRUBytes(1), port_mp100._LRUBytes(1)
    mib = 1 << 20
    for lru in (a, b):
        lru.put("x", 1, mib // 2)
        lru.put("y", 2, mib // 2)
        lru.get("x")
        lru.put("z", 3, mib // 2)          # evicts y, the least recent
        lru.put("big", 4, 2 * mib)         # larger than the budget: dropped
    for k in ("x", "y", "z", "big"):
        assert a.get(k) == b.get(k)
    assert (a.bytes, list(a.d)) == (b.bytes, list(b.d))


def test_augment_true_raises(paths, monkeypatch):
    """The train split augments, which requires cv2: where cv2 is missing a
    record raises and names it (the JAX package would skip the affine and
    the blurs in silence)."""
    tok = port_builder.DiscreteTokenizer(10, 24)
    ds = port_mp100.MP100Dataset(paths["img_dir"], paths["train_ann"], tok, 64)
    assert ds.augment and _dataset(PORT, paths, "train").augment
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="requires cv2"):
        ds.get_record(0, np.random.default_rng(0))
    monkeypatch.undo()
    # with augmentation off the train split loads like the JAX package's
    jd = _dataset(JAX, paths, "train", disable_augment=True)
    pd = _dataset(PORT, paths, "train", disable_augment=True)
    assert_tree_bytes_equal(pd.get_record(0)["image"], jd.get_record(0)["image"])


# -- sampler and batches ---------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(num_queries=1), dict(num_queries=2),
                                dict(num_queries=1, num_support=5),
                                dict(num_queries=1, overfit_category=5),
                                dict(num_queries=2, overfit_category=5,
                                     single_image=True)],
                         ids=["1q", "2q", "5shot", "overfit", "single_image"])
def test_sampler_matches_jax(paths, kw):
    split = "val" if kw.get("overfit_category", -1) < 0 else "test"
    js = _sampler(JAX, _dataset(JAX, paths, split), paths, split, **kw)
    ps = _sampler(PORT, _dataset(PORT, paths, split), paths, split, **kw)
    assert js.categories == ps.categories
    assert js.category_to_indices == ps.category_to_indices
    assert js.fixed_episodes(9, 4) == ps.fixed_episodes(9, 4)
    rj, rp = np.random.default_rng(11), np.random.default_rng(11)
    assert [js.sample_episode(rj) for _ in range(9)] == \
        [ps.sample_episode(rp) for _ in range(9)]
    assert rj.bit_generator.state == rp.bit_generator.state


def test_sampler_errors_match_jax(paths):
    for lib in (JAX, PORT):
        ds = _dataset(lib, paths)
        with pytest.raises(ValueError, match="Unknown split"):
            _sampler(lib, ds, paths, "nope")
        with pytest.raises(ValueError, match=">= 8 examples"):
            _sampler(lib, ds, paths, num_queries=4, num_support=4)


#: episode_batches cases: (sampler kwargs, episode_batches kwargs, fixed
#: episodes or None)
BATCH_CASES = {
    "fixed": (dict(num_queries=1), dict(batch_episodes=2, num_batches=3), 6),
    "random": (dict(num_queries=2), dict(batch_episodes=2, num_batches=3),
               None),
    "threads3": (dict(num_queries=1), dict(batch_episodes=4, num_batches=2,
                                           num_threads=3), None),
    "total_episodes": (dict(num_queries=1), dict(
        batch_episodes=4, num_batches=2, total_episodes=5), 5),
    "total_random": (dict(num_queries=1), dict(
        batch_episodes=3, num_batches=2, total_episodes=4), None),
    "support_noise": (dict(num_queries=1, num_support=2), dict(
        batch_episodes=2, num_batches=2, support_coord_noise=0.05), 4),
    "5shot": (dict(num_queries=1, num_support=5), dict(
        batch_episodes=2, num_batches=2, num_threads=2), 3),
}


def _batches(lib, paths, case, **override):
    skw, bkw, n_fixed = BATCH_CASES[case]
    bkw = dict(bkw, **override)
    cfg = _cfg(lib, paths)
    ds = lib[0].build_mp100_cape("val", cfg)
    sampler = _sampler(lib, ds, paths, **skw)
    fixed = None if n_fixed is None else sampler.fixed_episodes(n_fixed, 9)
    return list(lib[1].episode_batches(
        ds, sampler, image_size=cfg.image_size,
        max_support_keypoints=cfg.max_support_keypoints,
        max_skeleton_edges=cfg.max_skeleton_edges,
        rng=np.random.default_rng(0), fixed=fixed, **bkw))


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_episode_batches_match_jax(paths, case):
    """Every array of every batch byte-equal to the JAX pipeline's."""
    want = _batches(JAX, paths, case)
    got = _batches(PORT, paths, case)
    assert len(got) == len(want) == BATCH_CASES[case][1]["num_batches"]
    for g, w in zip(got, want):
        assert_tree_bytes_equal(g, w)
        port_episodic.validate_episode_batch(g)
    valid = np.concatenate([b["sample_valid"] for b in got])
    if case in ("total_episodes", "total_random"):
        cap = BATCH_CASES[case][1]["total_episodes"]
        n_q = BATCH_CASES[case][0]["num_queries"]
        assert valid.sum() == cap * n_q and not valid[cap * n_q:].any()
    if case == "threads3":
        # the thread pool gives the one-thread bytes
        for g, w in zip(_batches(PORT, paths, case, num_threads=1), got):
            assert_tree_bytes_equal(g, w)


MUTATIONS = {
    "none": lambda b: None,
    "support_coords rows": lambda b: b.update(
        support_coords=b["support_coords"][:1]),
    "bbox_dims rows": lambda b: b.update(bbox_dims=b["bbox_dims"][:1]),
    "target rows": lambda b: b["targets"].update(mask=b["targets"]["mask"][:1]),
    "mask dtype": lambda b: b.update(
        support_mask=b["support_mask"].astype(np.int32)),
    "coords rank": lambda b: b.update(
        support_coords=b["support_coords"][..., 0]),
    "edges shape": lambda b: b.update(
        skeleton_edges=b["skeleton_edges"][..., :1]),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_validate_episode_batch_matches_jax(paths, mutation):
    """The same mutations raise the same errors in both packages."""
    outcomes = []
    for lib, batch in ((jax_episodic, _batches(JAX, paths, "fixed")[0]),
                       (port_episodic, _batches(PORT, paths, "fixed")[0])):
        MUTATIONS[mutation](batch)
        try:
            lib.validate_episode_batch(batch)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (mutation == "none")


@pytest.mark.parametrize("n,b", [(1, 8), (12, 8), (16, 8), (5, 1), (3, 0),
                                 (200, 32)])
def test_eval_batch_plan_matches_jax(n, b):
    assert port_episodic.eval_batch_plan(n, b) == \
        jax_episodic.eval_batch_plan(n, b)


# -- split files -----------------------------------------------------------------
def _disjoint_annotations(root, dst):
    """The fixture's fold JSONs under `dst`, each listing only its own
    categories (the fixture lists every category in every file, so the
    official-split helpers find train and test overlapping)."""
    os.makedirs(dst)
    for f in sorted(os.listdir(os.path.join(root, "annotations"))):
        with open(os.path.join(root, "annotations", f)) as fh:
            doc = json.load(fh)
        used = {a["category_id"] for a in doc["annotations"]}
        doc["categories"] = [c for c in doc["categories"] if c["id"] in used]
        with open(os.path.join(dst, f), "w") as fh:
            json.dump(doc, fh)


def test_split_helpers_match_jax(paths, tmp_path):
    """`load_mp100_split`, `get_all_mp100_splits`, the fold-2 split file,
    and `resolve_split_file` for a configured path, the default name under
    the dataset root, the canonical split 1 and a synthesized fold 2."""
    root = paths["root"]
    for lib in (jax_splits, port_splits):     # the fixture's own JSONs
        with pytest.raises(ValueError, match="overlapping categories"):
            lib.load_mp100_split(root, 1)
    bare = tmp_path / "bare"
    _disjoint_annotations(root, str(bare / "annotations"))
    assert port_splits.get_all_mp100_splits(str(bare)) == \
        jax_splits.get_all_mp100_splits(str(bare))
    a = jax_splits.make_category_split_file(str(bare), 2,
                                            str(tmp_path / "j.json"))
    b = port_splits.make_category_split_file(str(bare), 2,
                                             str(tmp_path / "p.json"))
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    with open(jax_builder.CANONICAL_SPLIT1) as fa, \
            open(port_builder.CANONICAL_SPLIT1) as fb:
        assert json.load(fa) == json.load(fb)
    for kw in (dict(category_split_file=paths["split_file"]),
               dict(dataset_root=root),
               dict(dataset_root=str(bare)),
               dict(dataset_root=str(bare), mp100_split=2)):
        outs = []
        for lib, sub in ((JAX, "j"), (PORT, "p")):
            cfg = lib[2](**dict(kw, output_dir=str(tmp_path / sub)))
            with open(lib[0].resolve_split_file(cfg)) as f:
                outs.append(json.load(f))
        assert outs[0] == outs[1]
    for lib in (JAX, PORT):
        with pytest.raises(FileNotFoundError, match="not found"):
            lib[0].resolve_split_file(lib[2](category_split_file="nope.json"))
        with pytest.raises(FileNotFoundError, match="Annotation file"):
            lib[0].resolve_annotation_file(str(tmp_path), 1, "val")


# -- prefetch --------------------------------------------------------------------
def test_prefetch_yields_in_order_and_reraises():
    items = [{"a": np.full((2,), i)} for i in range(7)]
    got = list(port_prefetch.prefetch(iter(items), buffer_size=2,
                                      transform=lambda b: b["a"] * 2))
    assert [g.tolist() for g in got] == [[2 * i, 2 * i] for i in range(7)]

    def broken():
        yield 1
        yield 2
        raise KeyError("producer failed")

    seen = []
    with pytest.raises(KeyError, match="producer failed"):
        for x in port_prefetch.prefetch(broken()):
            seen.append(x)
    assert seen == [1, 2]

    def bad_transform(x):
        raise ValueError(f"transform of {x}")

    with pytest.raises(ValueError, match="transform of 0"):
        list(port_prefetch.prefetch(iter(range(3)), transform=bad_transform))


def test_stack_batches_matches_jax():
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(2, 3)).astype(np.float32),
                "targets": {"m": rng.integers(0, 2, (2, 4)).astype(bool)}}
               for _ in range(7)]
    want = list(jax_prefetch.stack_batches(iter(batches), 3))
    got = list(port_prefetch.stack_batches(iter(batches), 3))
    assert len(got) == len(want) == 2       # the last incomplete group drops
    for g, w in zip(got, want):
        assert_tree_bytes_equal(g, w)


def test_to_device_copies_read_only_arrays():
    """`to_device` copies every leaf into a tensor without the non-writable
    warning, so no tensor aliases a cached record array."""
    img = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    img.flags.writeable = False
    batch = {"query_images": img, "targets": {"mask": np.ones((2, 4), bool)}}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = port_prefetch.to_device(batch, "cpu")
    assert t["query_images"].dtype == torch.uint8
    assert t["targets"]["mask"].dtype == torch.bool
    t["query_images"] += 1
    assert np.array_equal(img, np.arange(12, dtype=np.uint8).reshape(2, 2, 3))


# -- no cv2, no PIL --------------------------------------------------------------
_NO_LIBS = r"""
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.modules["jax"] = None
import json
import numpy as np
from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.data import builder, episodic, image, mp100
from cape_tpu_torch.data.synthetic import make_synthetic_mp100

root, jpeg, out = sys.argv[1:4]
assert image.RESIZE_ROUTE == "torch-bilinear", image.RESIZE_ROUTE
assert image.DECODE_ROUTE == "own-png", image.DECODE_ROUTE
assert image.library_versions() == {"cv2": "absent", "PIL": "absent"}
p = make_synthetic_mp100(root, **json.loads(sys.argv[4]))
cfg = tiny_test_config(dataset_root=root, category_split_file=p["split_file"])
ds = builder.build_mp100_cape("val", cfg)
sampler = episodic.EpisodicSampler(ds, p["split_file"], "val", num_queries=1)
batch = next(episodic.episode_batches(
    ds, sampler, 2, 1, cfg.image_size, cfg.max_support_keypoints,
    cfg.max_skeleton_edges, np.random.default_rng(0),
    fixed=sampler.fixed_episodes(2, 9)))
np.savez(out, query_images=batch["query_images"],
         support_coords=batch["support_coords"],
         target_seq=batch["targets"]["target_seq"])
try:
    image.decode_rgb(jpeg)
    raise SystemExit("the JPEG decoded")
except RuntimeError as e:
    assert "cv2" in str(e) and "Pillow" in str(e), e
# through the dataset and the resampling loader: no ImageNotFoundError
doc = json.load(open(p["val_ann"]))
doc["images"][0]["file_name"] = jpeg
ds = mp100.MP100Dataset(p["img_dir"], doc, ds.tokenizer, 64, split="val")
ep = {"category_id": doc["annotations"][0]["category_id"],
      "support_indices": [0], "query_indices": [1]}
try:
    episodic.load_episode(ds, ep, np.random.default_rng(0), sampler=sampler)
    raise SystemExit("the JPEG episode loaded")
except RuntimeError as e:
    assert "not a PNG" in str(e), e
print("ok")
"""


def test_without_cv2_and_pil(paths, tmp_path):
    """A process without cv2 and PIL writes the fixture and builds a batch
    through the port's own PNG writer, reader and bilinear resize: within
    1 level of the cv2 batch, everything else equal. A JPEG there raises
    `RuntimeError` (never `ImageNotFoundError`, which would resample it
    away)."""
    jpeg = str(tmp_path / "photo.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg)
    out = str(tmp_path / "batch.npz")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_LIBS, str(tmp_path / "tree"), jpeg, out,
         json.dumps(FIXTURE)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    cfg = _cfg(PORT, paths)
    ds = port_builder.build_mp100_cape("val", cfg)
    sampler = _sampler(PORT, ds, paths, num_queries=1)
    want = next(port_episodic.episode_batches(
        ds, sampler, 2, 1, cfg.image_size, cfg.max_support_keypoints,
        cfg.max_skeleton_edges, np.random.default_rng(0),
        fixed=sampler.fixed_episodes(2, 9)))
    got = np.load(out)
    diff = np.abs(got["query_images"].astype(int)
                  - want["query_images"].astype(int))
    assert diff.max() <= 1
    np.testing.assert_array_equal(got["support_coords"], want["support_coords"])
    np.testing.assert_array_equal(got["target_seq"],
                                  want["targets"]["target_seq"])

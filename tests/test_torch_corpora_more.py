"""The four corpora of the fluid surface slice in the port against the
JAX package's: ``wmt16``, ``sentiment``, ``flowers`` and ``mq2007``, with
``dataset.image`` (numpy-only copies; the port imports nothing of
paddle_tpu). Each reader's first samples equal the JAX package's field
for field, bit for bit, and so do the dicts; ``image``'s transforms give
the same arrays on the same image, and without PIL its decoders raise the
same named error.
"""
import itertools
import os

import numpy as np
import pytest

from paddle_tpu import dataset as jds
from paddle_tpu_torch import dataset as tds

N = 48


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _first(reader, n=N):
    return list(itertools.islice(reader(), n))


@pytest.mark.parametrize("split,lang", [("train", "en"), ("test", "de"),
                                        ("validation", "en")])
def test_wmt16(split, lang):
    j = getattr(jds.wmt16, split)(300, 200, lang)
    t = getattr(tds.wmt16, split)(300, 200, lang)
    _same(_first(t), _first(j))
    for reverse in (False, True):
        _same(tds.wmt16.get_dict("de", 50, reverse),
              jds.wmt16.get_dict("de", 50, reverse))
    with pytest.raises(ValueError, match="language"):
        tds.wmt16.train(10, 10, "fr")


def test_sentiment():
    _same(tds.sentiment.get_word_dict(), jds.sentiment.get_word_dict())
    _same(_first(tds.sentiment.train()), _first(jds.sentiment.train()))
    _same(_first(tds.sentiment.test()), _first(jds.sentiment.test()))
    assert len(list(tds.sentiment.test()())) == \
        tds.sentiment.NUM_TOTAL_INSTANCES - \
        tds.sentiment.NUM_TRAINING_INSTANCES


@pytest.mark.parametrize("split", ["train", "test", "val"])
def test_flowers(split):
    """The raw samples equal the JAX package's, and so does each mapper
    on one array. (The train mapper seeds its jitter from the image's
    float32 sum, whose last bit numpy may round differently for two
    copies of an array at other alignments: so readers are compared
    mapper against mapper on the same object, never copy against
    copy.)"""
    raw = [tds.flowers._sample(split, i) for i in range(16)]
    _same(raw, [jds.flowers._sample(split, i) for i in range(16)])
    for mapper in ("train_mapper", "test_mapper"):
        for sample in raw:
            _same(getattr(tds.flowers, mapper)(sample),
                  getattr(jds.flowers, mapper)(sample))
    creator = {"val": "valid"}.get(split, split)
    got = _first(getattr(tds.flowers, creator)(use_xmap=False), 16)
    assert [(img.shape, img.dtype, lab) for img, lab in got] == \
        [((3 * 64 * 64,), np.float32, lab) for _, lab in raw]
    if split != "train":
        _same(got, [tds.flowers.test_mapper(r) for r in raw])
        # the xmap (threaded) reader yields the same samples, in the
        # order its workers finish them (unordered, as the JAX
        # package's): the whole split as a multiset
        def by_bytes(samples):
            return sorted(samples, key=lambda s: (s[1], s[0].tobytes()))
        _same(by_bytes(getattr(tds.flowers, creator)(
            use_xmap=True, buffered_size=8)()),
              by_bytes(getattr(tds.flowers, creator)(use_xmap=False)()))


@pytest.mark.parametrize("fmt", ["pointwise", "pairwise", "listwise",
                                 "plain_txt"])
def test_mq2007(fmt):
    _same(_first(lambda: tds.mq2007.train(format=fmt)),
          _first(lambda: jds.mq2007.train(format=fmt)))
    _same(_first(lambda: tds.mq2007.test(format=fmt)),
          _first(lambda: jds.mq2007.test(format=fmt)))
    ql = tds.mq2007._make_querylists("train")[0]
    jql = jds.mq2007._make_querylists("train")[0]
    assert str(ql[0]) == str(jql[0]) and len(ql) == len(jql)


def test_image_transforms():
    rng = np.random.RandomState(0)
    im = rng.randint(0, 256, (40, 30, 3)).astype(np.uint8)
    for fn, args in (("resize_short", (24,)), ("to_chw", ()),
                     ("center_crop", (16,)), ("left_right_flip", ())):
        _same(getattr(tds.image, fn)(im, *args),
              getattr(jds.image, fn)(im, *args))
    for is_train in (False, True):
        np.random.seed(4)
        want = jds.image.simple_transform(im, 32, 20, is_train,
                                          mean=[1.0, 2.0, 3.0])
        np.random.seed(4)
        got = tds.image.simple_transform(im, 32, 20, is_train,
                                         mean=[1.0, 2.0, 3.0])
        _same(got, want)


def test_image_decoders_without_pil(monkeypatch, tmp_path):
    """The card's machine has no PIL: decoding raises the JAX package's
    named error, and resize_short falls back to numpy."""
    monkeypatch.setattr(tds.image, "_PILImage", None)
    monkeypatch.setattr(jds.image, "_PILImage", None)
    path = str(tmp_path / "x.png")
    for mod in (tds.image, jds.image):
        with pytest.raises(RuntimeError, match="PIL is unavailable"):
            mod.load_image(path)
        with pytest.raises(RuntimeError, match="PIL is unavailable"):
            mod.load_image_bytes(b"")
    im = np.arange(7 * 5, dtype=np.uint8).reshape(7, 5)
    _same(tds.image.resize_short(im, 3), jds.image.resize_short(im, 3))


def test_batch_images_from_tar(tmp_path):
    import tarfile
    src = tmp_path / "imgs"
    src.mkdir()
    names = []
    for i in range(5):
        p = src / ("%d.jpg" % i)
        p.write_bytes(bytes([i]) * (i + 3))
        names.append(p)
    tar_path = str(tmp_path / "imgs.tar")
    with tarfile.open(tar_path, "w") as tf:
        for p in names:
            tf.add(str(p), arcname=p.name)
    img2label = {p.name: i % 2 for i, p in enumerate(names)}
    meta = tds.image.batch_images_from_tar(tar_path, "flowers", img2label,
                                           num_per_batch=2)
    with open(meta) as f:
        files = sorted(f.read().split())
    assert len(files) == 3 and all(os.path.exists(p) for p in files)


def test_common_fetch_all_covers_the_new_corpora(monkeypatch):
    fetched = []
    for name in ("sentiment", "wmt16", "flowers", "mq2007"):
        monkeypatch.setattr(getattr(tds, name), "fetch",
                            lambda n=name: fetched.append(n))
    tds.common.fetch_all()
    assert fetched == ["sentiment", "wmt16", "flowers", "mq2007"]

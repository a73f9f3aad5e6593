"""The port's dataset readers, image helpers and sharded readers
(`paddle_tpu_torch/data/{datasets/*,image,sharded_reader}.py`) against the
JAX package's, on the CPU; numpy only.

  * Both packages' `common.DATA_HOME` point at one empty directory and the
    JAX package's network fetch is stubbed to fail, so every reader takes
    its synthetic branch: every public reader (and dict builder) of every
    dataset module yields the JAX package's records record for record,
    with the same types and dtypes (all records of the small readers, the
    first 256 of the large ones).
  * Each real format is parsed from a small file the test writes (mnist
    idx-gz, cifar pickle tars, the aclImdb tar, the simple-examples tgz,
    the wmt14 tgz, housing.data, the ml-1m zip, CoNLL chunking text),
    through the modules' parsers and, with `download` resolved to that
    file, through the public readers.
  * The port's `download` returns a cached file whose md5 matches and
    raises `DownloadUnavailable` otherwise, never calling
    `urllib.request.urlretrieve`; no port module imports urllib.
  * `data/image.py` and `data/sharded_reader.py` on seeded arrays and
    lists, `random_crop` and `simple_transform` on a shared RandomState,
    and the 1 / 0 shard defaults without a process group.
jax is imported inside the tests only."""

import ast
import gzip
import io
import itertools
import pathlib
import pickle
import struct
import tarfile
import zipfile

import numpy as np
import pytest

from paddle_tpu_torch.data import datasets as tds
from paddle_tpu_torch.data import image as timage
from paddle_tpu_torch.data import sharded_reader as tsr
from paddle_tpu_torch.data.datasets import common as tcommon

REPO = pathlib.Path(__file__).resolve().parents[1]
LARGE = 256  # records compared of a reader longer than SMALL
SMALL = 600


def _jax_datasets():
    from paddle_tpu.data import datasets
    return datasets


@pytest.fixture
def both(tmp_path, monkeypatch):
    """(jax datasets, port datasets), both caching under one empty
    directory; the JAX package's fetch fails as it does offline."""
    import urllib.request

    jds = _jax_datasets()

    def offline(url, *a, **k):
        raise OSError(f"offline: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    for ds in (jds, tds):
        monkeypatch.setattr(ds.common, "DATA_HOME", str(tmp_path / "home"))
        monkeypatch.setattr(ds.common, "SYNTHETIC", False)
    return jds, tds


def _same(a, b, where="record"):
    """Equal values with equal types, dtypes and shapes, recursively."""
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: {len(a)} vs {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), f"{where}: keys differ"
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


def _same_records(want_reader, got_reader, what):
    want = list(itertools.islice(want_reader(), SMALL + 1))
    got = list(itertools.islice(got_reader(), SMALL + 1))
    if len(want) > SMALL:
        want, got = want[:LARGE], got[:LARGE]
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(want, got)):
        _same(a, b, f"{what} #{i}")
    return len(want)


# every public reader, as a function of the datasets package
READERS = {
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test10": lambda d: d.cifar.test10(),
    "cifar.train100": lambda d: d.cifar.train100(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "uci_housing.test": lambda d: d.uci_housing.test(),
    "imikolov.train": lambda d: d.imikolov.train(d.imikolov.build_dict(), 5),
    "imikolov.test": lambda d: d.imikolov.test(d.imikolov.build_dict(), 3),
    "imdb.train": lambda d: d.imdb.train(d.imdb.word_dict()),
    "imdb.test": lambda d: d.imdb.test(d.imdb.word_dict()),
    "conll05.test": lambda d: d.conll05.test(),
    "movielens.train": lambda d: d.movielens.train(),
    "movielens.test": lambda d: d.movielens.test(),
    "sentiment.train": lambda d: d.sentiment.train(),
    "sentiment.test": lambda d: d.sentiment.test(),
    "mq2007.train.pointwise": lambda d: d.mq2007.train("pointwise"),
    "mq2007.train.pairwise": lambda d: d.mq2007.train("pairwise"),
    "mq2007.train.listwise": lambda d: d.mq2007.train("listwise"),
    "mq2007.test.pointwise": lambda d: d.mq2007.test("pointwise"),
    "mq2007.test.pairwise": lambda d: d.mq2007.test(),
    "mq2007.test.listwise": lambda d: d.mq2007.test("listwise"),
    "wmt14.train": lambda d: d.wmt14.train(30000),
    "wmt14.test": lambda d: d.wmt14.test(30000),
    "wmt14.train.small": lambda d: d.wmt14.train(64),
    "flowers.train": lambda d: d.flowers.train(),
    "flowers.test": lambda d: d.flowers.test(),
    "flowers.valid.mapped": lambda d: d.flowers.valid(
        mapper=lambda s: (s[0][:, ::8, ::8] * 2.0, s[1])),
    "voc2012.train": lambda d: d.voc2012.train(),
    "voc2012.test": lambda d: d.voc2012.test(),
    "voc2012.val": lambda d: d.voc2012.val(),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_synthetic_records_equal_jax(both, name):
    jds, pds = both
    n = _same_records(READERS[name](jds), READERS[name](pds), name)
    assert pds.common.SYNTHETIC and jds.common.SYNTHETIC
    assert n >= 1
    # no file was written, let alone fetched
    home = pathlib.Path(pds.common.DATA_HOME)
    assert not [p for p in home.rglob("*") if p.is_file()]


DICTS = {
    "imdb.word_dict": lambda d: d.imdb.word_dict(),
    "imikolov.build_dict": lambda d: d.imikolov.build_dict(),
    "conll05.get_dict": lambda d: d.conll05.get_dict(),
    "sentiment.get_word_dict": lambda d: d.sentiment.get_word_dict(),
    "wmt14.get_dict": lambda d: d.wmt14.get_dict(30000),
    "movielens.tables": lambda d: (d.movielens.max_user_id(), d.movielens.max_movie_id(),
                                   d.movielens.max_job_id(), d.movielens.age_table(),
                                   d.movielens.movie_categories()),
    "constants": lambda d: (d.conll05.WORD_DICT_LEN, d.conll05.LABEL_DICT_LEN,
                            d.conll05.PRED_DICT_LEN, d.flowers.NUM_CLASSES,
                            d.flowers.IMAGE_SHAPE, d.voc2012.NUM_CLASSES, d.mq2007.FEATURE_DIM,
                            d.uci_housing.FEATURE_NUM, d.sentiment.NUM_TRAINING_INSTANCES,
                            d.wmt14.START_ID, d.wmt14.END_ID, d.wmt14.UNK_ID,
                            d.common.rng("x").randint(0, 2**31, 4).tolist()),
}


@pytest.mark.parametrize("name", sorted(DICTS))
def test_dict_builders_equal_jax(both, name):
    jds, pds = both
    _same(DICTS[name](jds), DICTS[name](pds), name)


def test_package_surface_and_conll05_embedding(both):
    jds, pds = both
    mods = ("cifar", "common", "conll05", "flowers", "imdb", "imikolov", "mnist",
            "movielens", "mq2007", "sentiment", "uci_housing", "voc2012", "wmt14")
    for m in mods:
        assert getattr(pds, m).__name__ == f"paddle_tpu_torch.data.datasets.{m}"
        jpub = {k for k in vars(getattr(jds, m)) if not k.startswith("_")}
        ppub = {k for k in vars(getattr(pds, m)) if not k.startswith("_")}
        assert jpub == ppub, m
    for ds in (jds, pds):
        with pytest.raises(ds.common.DownloadUnavailable, match="network"):
            ds.conll05.get_embedding()
    import paddle_tpu_torch.v2 as paddle

    assert paddle.dataset is pds and paddle.image is timage


# -- real formats on files the test writes -----------------------------------


def _tar(path, members):
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return str(path)


def _use_files(monkeypatch, files):
    """Resolve both packages' `download(url, module, md5)` to the written
    file of that url's name, or else of that module."""
    def download(url, module, md5=None):
        return files.get(url.split("/")[-1], files.get(module))

    for ds in (_jax_datasets(), tds):
        monkeypatch.setattr(ds.common, "download", download)


def test_mnist_idx_gz(both, tmp_path, monkeypatch):
    jds, pds = both
    rs = np.random.RandomState(0)
    files = {}
    for split, n in (("train", 7), ("t10k", 3)):
        img, lbl = tmp_path / f"{split}-images.gz", tmp_path / f"{split}-labels.gz"
        with gzip.open(img, "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28)
                    + rs.randint(0, 256, n * 784).astype(np.uint8).tobytes())
        with gzip.open(lbl, "wb") as f:
            f.write(struct.pack(">II", 2049, n) + rs.randint(0, 10, n).astype(np.uint8).tobytes())
        files[f"{split}-images-idx3-ubyte.gz"] = str(img)
        files[f"{split}-labels-idx1-ubyte.gz"] = str(lbl)
    _same_records(jds.mnist._reader_from_idx(str(img), str(lbl)),
                  pds.mnist._reader_from_idx(str(img), str(lbl)), "mnist idx")
    _use_files(monkeypatch, files)
    assert _same_records(jds.mnist.train(), pds.mnist.train(), "mnist.train") == 7
    assert _same_records(jds.mnist.test(), pds.mnist.test(), "mnist.test") == 3
    assert not pds.common.SYNTHETIC


@pytest.mark.parametrize("which", ["10", "100"])
def test_cifar_pickle_tar(both, tmp_path, monkeypatch, which):
    jds, pds = both
    rs = np.random.RandomState(1)
    key = "labels" if which == "10" else "fine_labels"
    members = {}
    for part, n in (("data_batch_1", 5), ("data_batch_2", 3), ("test_batch", 4),
                    ("train", 6), ("test", 2)):
        batch = {"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                 key: rs.randint(0, int(which), n).tolist()}
        members[f"cifar-{which}-python/{part}"] = pickle.dumps(batch, protocol=2)
    path = _tar(tmp_path / f"cifar{which}.tar.gz", members)
    for sub in (("data_batch", "test_batch") if which == "10" else ("train", "test")):
        _same_records(jds.cifar._reader_from_tar(path, sub, key),
                      pds.cifar._reader_from_tar(path, sub, key), f"cifar {sub}")
    _use_files(monkeypatch, {"cifar": path})
    for fn in (("train10", "test10") if which == "10" else ("train100", "test100")):
        _same_records(getattr(jds.cifar, fn)(), getattr(pds.cifar, fn)(), fn)
    assert not pds.common.SYNTHETIC


def test_imdb_acl_tar(both, tmp_path, monkeypatch):
    jds, pds = both
    rs = np.random.RandomState(2)
    words = ["good", "bad", "movie", "plot", "the", "a", "great", "awful", "film", "x"]
    members = {}
    for split in ("train", "test"):
        for pol in ("pos", "neg"):
            for i in range(3):
                text = " ".join(words[j] for j in rs.randint(0, len(words), 12))
                members[f"aclImdb/{split}/{pol}/{i}_7.txt"] = (text.title() + "!").encode("latin1")
    path = _tar(tmp_path / "aclImdb_v1.tar.gz", members)
    pat = r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"
    _same(jds.imdb._build_dict_from_tar(path, pat, cutoff=2),
          pds.imdb._build_dict_from_tar(path, pat, cutoff=2), "imdb dict")
    assert pds.imdb._tokenize("It's A Film!") == jds.imdb._tokenize("It's A Film!")
    _use_files(monkeypatch, {"imdb": path})
    _same(jds.imdb.word_dict(), pds.imdb.word_dict(), "imdb.word_dict")
    wd = pds.imdb.word_dict()
    _same_records(jds.imdb.train(wd), pds.imdb.train(wd), "imdb.train")
    _same_records(jds.imdb.test(wd), pds.imdb.test(wd), "imdb.test")


def test_imikolov_simple_examples_tgz(both, tmp_path, monkeypatch):
    jds, pds = both
    rs = np.random.RandomState(3)
    vocab = [f"t{i}" for i in range(12)] + ["<unk>"]

    def text(n):
        return "\n".join(" " + " ".join(vocab[j] for j in rs.randint(0, len(vocab), 8)) + " "
                         for _ in range(n)).encode()

    path = _tar(tmp_path / "simple-examples.tgz", {
        "./simple-examples/data/ptb.train.txt": text(30),
        "./simple-examples/data/ptb.valid.txt": text(6)})
    _use_files(monkeypatch, {"imikolov": path})
    for freq in (0, 15):
        _same(jds.imikolov.build_dict(freq), pds.imikolov.build_dict(freq), "build_dict")
    wd = pds.imikolov.build_dict(15)
    _same_records(jds.imikolov.train(wd, 5), pds.imikolov.train(wd, 5), "imikolov.train")
    _same_records(jds.imikolov.test(wd, 2), pds.imikolov.test(wd, 2), "imikolov.test")
    assert not pds.common.SYNTHETIC


def test_wmt14_tgz(both, tmp_path, monkeypatch):
    jds, pds = both
    rs = np.random.RandomState(4)
    src_words = ["<s>", "<e>", "<unk>"] + [f"le{i}" for i in range(10)]
    trg_words = ["<s>", "<e>", "<unk>"] + [f"the{i}" for i in range(10)]

    def pairs(n):
        lines = []
        for _ in range(n):
            s = " ".join(f"le{j}" for j in rs.randint(0, 14, rs.randint(1, 6)))
            t = " ".join(f"the{j}" for j in rs.randint(0, 14, rs.randint(1, 6)))
            lines.append(f"{s}\t{t}")
        lines.append("no tab here")
        return "\n".join(lines).encode("latin1")

    path = _tar(tmp_path / "wmt14.tgz", {
        "wmt14/src.dict": "\n".join(src_words).encode("latin1"),
        "wmt14/trg.dict": "\n".join(trg_words).encode("latin1"),
        "wmt14/train/train": pairs(20), "wmt14/test/test": pairs(5)})
    for size in (13, 8):
        _same(jds.wmt14._load_dicts(path, size), pds.wmt14._load_dicts(path, size), "dicts")
        _same_records(jds.wmt14._real_reader(path, "train/train", size),
                      pds.wmt14._real_reader(path, "train/train", size), "wmt14 real")
    _use_files(monkeypatch, {"wmt14": path})
    _same_records(jds.wmt14.test(8), pds.wmt14.test(8), "wmt14.test")
    _same(jds.wmt14.get_dict(8), pds.wmt14.get_dict(8), "wmt14.get_dict")


def test_uci_housing_data(both, tmp_path, monkeypatch):
    jds, pds = both
    rs = np.random.RandomState(5)
    path = tmp_path / "housing.data"
    np.savetxt(path, np.abs(rs.randn(20, 14)) * 10, fmt="%.4f")
    for a, b in zip(jds.uci_housing._load(str(path)), pds.uci_housing._load(str(path))):
        _same(a, b, "uci _load")
    _use_files(monkeypatch, {"uci_housing": str(path)})
    _same_records(jds.uci_housing.train(), pds.uci_housing.train(), "uci.train")
    _same_records(jds.uci_housing.test(), pds.uci_housing.test(), "uci.test")


def test_movielens_ml1m_zip(both, tmp_path, monkeypatch):
    jds, pds = both
    path = tmp_path / "ml-1m.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/users.dat", "1::F::1::10::48067\n2::M::56::16::70072\n"
                                      "3::M::25::15::55117\n")
        z.writestr("ml-1m/movies.dat", "1::Toy Story (1995)::Animation|Children's|Comedy\n"
                                       "2::Jumanji (1995)::Adventure|Children's|Fantasy\n"
                                       "5::Father of the Bride Part II (1995)::Comedy\n")
        z.writestr("ml-1m/ratings.dat", "".join(
            f"{u}::{m}::{(u * m) % 5 + 1}::97830{u}{m}\n"
            for u in (4, 1, 2, 3) for m in (7, 1, 2, 5)))
    _same(jds.movielens._parse(str(path)), pds.movielens._parse(str(path)), "ml _parse")
    _use_files(monkeypatch, {"movielens": str(path)})
    _same_records(jds.movielens.train(), pds.movielens.train(), "movielens.train")
    _same_records(jds.movielens.test(), pds.movielens.test(), "movielens.test")


def test_conll_chunking_text(tmp_path):
    from paddle_tpu.data.datasets import conll_chunking as jcc

    from paddle_tpu_torch.data.datasets import conll_chunking as pcc

    rs = np.random.RandomState(6)
    words = ["He", "reckons", "the", "current", "account", "deficit", "will", "narrow"]
    pos = ["PRP", "VBZ", "DT", "JJ", "NN", "NN", "MD", "VB"]
    chunks = list(pcc.CHUNK_DICT)

    def text(n):
        out = []
        for _ in range(n):
            for _k in range(rs.randint(3, 9)):
                j = rs.randint(0, len(words))
                out.append(f"{words[j]} {pos[j]} {chunks[rs.randint(0, len(chunks))]}")
            out.append("")
        return "\n".join(out) + "\n"

    train, test = tmp_path / "train.txt", tmp_path / "test.txt"
    train.write_text(text(12))
    # the test split only uses words and tags the training split has
    test.write_text(train.read_text().split("\n\n", 3)[0] + "\n")
    seq = [["He", "PRP", "B-NP"], ["reckons", "VBZ", "B-VP"]]
    a, b = [list(x) for x in seq], [list(x) for x in seq]
    jcc.make_features(a)
    pcc.make_features(b)
    assert a == b
    _same(jcc.default_dicts(str(train)), pcc.default_dicts(str(train)), "dicts")
    jout = jcc.build_chunking_shards(str(train), str(test), str(tmp_path / "jax"))
    pout = pcc.build_chunking_shards(str(train), str(test), str(tmp_path / "port"))
    assert {k: v for k, v in jout.items() if k != "dir"} == {
        k: v for k, v in pout.items() if k != "dir"}
    for rel in ("train_proto.bin", "test_proto.bin", "train_files.txt", "test_files.txt"):
        j = (tmp_path / "jax" / "trainer" / "tests" / rel).read_bytes()
        assert (tmp_path / "port" / "trainer" / "tests" / rel).read_bytes() == j, rel


# -- download never fetches ---------------------------------------------------


def test_download_reads_only_the_cache(tmp_path, monkeypatch):
    import urllib.request

    def no_network(*a, **k):
        pytest.fail("download reached urllib.request.urlretrieve")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(tcommon, "DATA_HOME", str(tmp_path))
    url = "http://example.invalid/dir/data.bin"
    with pytest.raises(tcommon.DownloadUnavailable, match="not cached"):
        tcommon.download(url, "mod", "0" * 32)
    cached = tmp_path / "mod" / "data.bin"
    cached.write_bytes(b"cached bytes")
    md5 = tcommon.md5file(str(cached))
    assert tcommon.download(url, "mod", md5) == str(cached)
    assert tcommon.download(url, "mod") == str(cached)
    with pytest.raises(tcommon.DownloadUnavailable, match="md5"):
        tcommon.download(url, "mod", "f" * 32)
    assert cached.read_bytes() == b"cached bytes"
    # a reader with nothing cached falls back to its synthetic records
    monkeypatch.setattr(tcommon, "SYNTHETIC", False)
    assert next(tds.uci_housing.train()())[0].shape == (13,)
    assert tcommon.SYNTHETIC


def test_data_home_default_and_md5_match_jax(both):
    jds, pds = both
    for ds in (jds, pds):  # the same variable and default
        src = pathlib.Path(ds.common.__file__).read_text()
        assert 'os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset")' in src
    assert pds.common.md5file(__file__) == jds.common.md5file(__file__)


def test_no_port_module_imports_urllib():
    hits = []
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            hits += [f"{path.relative_to(REPO)}: {n}" for n in names
                     if n == "urllib" or n.startswith("urllib.")]
    assert hits == []


# -- image helpers -------------------------------------------------------------


def _jimage():
    from paddle_tpu.data import image
    return image


@pytest.mark.parametrize("shape,size", [((20, 30, 3), 12), ((31, 17), 9), ((16, 24, 3), 16),
                                        ((12, 12, 1), 12)])
def test_resize_and_crops_equal_jax(shape, size):
    ji = _jimage()
    im = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    for fn in ("resize_short", "center_crop", "left_right_flip"):
        args = (im,) if fn == "left_right_flip" else (im, size)
        _same(getattr(ji, fn)(*args), getattr(timage, fn)(*args), fn)
    _same(ji._bilinear_resize(im, 7, 11), timage._bilinear_resize(im, 7, 11), "bilinear")
    _same(ji.random_crop(im, size, np.random.RandomState(3)),
          timage.random_crop(im, size, np.random.RandomState(3)), "random_crop")
    col = ji.resize_short(im, size)
    _same(ji.to_chw(col), timage.to_chw(col), "to_chw")


def test_simple_transform_equal_jax():
    ji = _jimage()
    im = np.random.RandomState(8).randint(0, 256, (40, 52, 3)).astype(np.uint8)
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    for is_train in (True, False):
        for m in (None, mean):
            for seed in range(4):
                _same(ji.simple_transform(im, 32, 24, is_train, m, np.random.RandomState(seed)),
                      timage.simple_transform(im, 32, 24, is_train, m,
                                              np.random.RandomState(seed)),
                      f"simple_transform train={is_train}")


# -- sharded readers -------------------------------------------------------------


def test_sharded_readers_equal_jax():
    from paddle_tpu.data import sharded_reader as jsr

    def reader():
        return iter(range(23))

    files = [f"part-{i:05d}" for i in range(10)]
    for n in (1, 3, 4):
        for i in range(n):
            assert list(tsr.shard_reader(reader, n, i)()) == list(jsr.shard_reader(reader, n, i)())
            assert tsr.shard_file_list(files, n, i) == jsr.shard_file_list(files, n, i)
    # defaults without a process group: one shard, this one
    import torch.distributed as dist

    assert not (dist.is_available() and dist.is_initialized())
    assert list(tsr.shard_reader(reader)()) == list(jsr.shard_reader(reader)()) == list(range(23))
    assert tsr.shard_file_list(files) == jsr.shard_file_list(files) == files
    for mod in (tsr, jsr):
        with pytest.raises(ValueError, match="out of range"):
            mod.shard_reader(reader, 2, 2)
        with pytest.raises(ValueError, match="out of range"):
            mod.shard_file_list(files, shard_id=1)

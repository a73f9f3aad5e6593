"""WMT-14 fr→en seq2seq readers (python/paddle/v2/dataset/wmt14.py).

Record schema: (src_ids, trg_ids_with_<s>, trg_ids_with_<e>) — the NMT
teacher-forcing triple. Special ids: <s>=0, <e>=1, <unk>=2 (wmt14.py constants).
"""

from __future__ import annotations

import tarfile
from typing import Dict, Tuple

from paddle_tpu_torch.data.datasets import common

URL_TRAIN = "http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/wmt14.tgz"
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"

START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID, END_ID, UNK_ID = 0, 1, 2


def _synth_dicts(dict_size: int) -> Tuple[Dict[str, int], Dict[str, int]]:
    src = {START: 0, END: 1, UNK: 2}
    trg = {START: 0, END: 1, UNK: 2}
    for i in range(3, dict_size):
        src[f"f{i}"] = i
        trg[f"e{i}"] = i
    return src, trg


def _synthetic_reader(dict_size: int, n: int, tag: str):
    def reader():
        rs = common.rng("wmt14." + tag)
        for _ in range(n):
            length = int(rs.randint(4, 20))
            src = rs.randint(3, dict_size, length).tolist()
            # learnable mapping: target token = src token shifted by 1 mod vocab
            trg = [3 + ((t - 3 + 1) % (dict_size - 3)) for t in src]
            yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def _real_reader(tar_file: str, file_name: str, dict_size: int):
    src_dict, trg_dict = _load_dicts(tar_file, dict_size)

    def reader():
        with tarfile.open(tar_file) as tar:
            for member in tar.getmembers():
                if file_name not in member.name:
                    continue
                f = tar.extractfile(member)
                assert f is not None
                for line in f.read().decode("latin1").splitlines():
                    cols = line.split("\t")
                    if len(cols) != 2:
                        continue
                    src = [src_dict.get(w, UNK_ID) for w in cols[0].split()]
                    trg = [trg_dict.get(w, UNK_ID) for w in cols[1].split()]
                    if not src or not trg:
                        continue
                    yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def _load_dicts(tar_file: str, dict_size: int):
    src_dict: Dict[str, int] = {}
    trg_dict: Dict[str, int] = {}
    with tarfile.open(tar_file) as tar:
        for member in tar.getmembers():
            target = src_dict if "src.dict" in member.name else (
                trg_dict if "trg.dict" in member.name else None)
            if target is None:
                continue
            f = tar.extractfile(member)
            assert f is not None
            for i, line in enumerate(f.read().decode("latin1").splitlines()):
                if i >= dict_size:
                    break
                target[line.split()[0]] = i
    return src_dict, trg_dict


def train(dict_size: int = 30000):
    return common.fetch_or_synthetic(
        lambda: _real_reader(common.download(URL_TRAIN, "wmt14", MD5_TRAIN), "train/train", dict_size),
        lambda: _synthetic_reader(dict_size, 4096, "train"),
        "wmt14.train",
    )


def test(dict_size: int = 30000):
    return common.fetch_or_synthetic(
        lambda: _real_reader(common.download(URL_TRAIN, "wmt14", MD5_TRAIN), "test/test", dict_size),
        lambda: _synthetic_reader(dict_size, 256, "test"),
        "wmt14.test",
    )


def get_dict(dict_size: int = 30000):
    def fetch():
        path = common.download(URL_TRAIN, "wmt14", MD5_TRAIN)
        src, trg = _load_dicts(path, dict_size)
        return {i: w for w, i in src.items()}, {i: w for w, i in trg.items()}

    def synth():
        src, trg = _synth_dicts(dict_size)
        return {i: w for w, i in src.items()}, {i: w for w, i in trg.items()}

    return common.fetch_or_synthetic(fetch, synth, "wmt14.get_dict")

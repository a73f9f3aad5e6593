"""CoNLL-2000 chunking text → DataFormat proto shards.

Behavioral port of the reference's data generator
(paddle/trainer/tests/gen_proto_data.py): context-window feature patterns
over the (word, POS) columns, frequency-cutoff dictionaries, and one
VECTOR_SPARSE_NON_VALUE feature slot followed by INDEX slots for the three
original columns. Feeding chunking.conf requires the exact same dictionary
sizes (features 4339 / word 478 / pos 45 / chunk 23 on the in-tree
train.txt); id assignment order differs from the py2 generator's dict order,
which only permutes feature ids, never the dimensionality."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

from paddle_tpu_torch.data.proto_data import (
    INDEX,
    VECTOR_SPARSE_NON_VALUE,
    DataSample,
    SlotDef,
    VectorSlot,
    write_shard,
)

OOV_POLICY_IGNORE = 0
OOV_POLICY_USE = 1
OOV_POLICY_ERROR = 2

NUM_ORIGINAL_COLUMNS = 3

# context feature combination patterns (gen_proto_data.py:35): [offset, column]
PATTERNS: List[List[Tuple[int, int]]] = [
    [(-2, 0)], [(-1, 0)], [(0, 0)], [(1, 0)], [(2, 0)],
    [(-1, 0), (0, 0)], [(0, 0), (1, 0)],
    [(-2, 1)], [(-1, 1)], [(0, 1)], [(1, 1)], [(2, 1)],
    [(-2, 1), (-1, 1)], [(-1, 1), (0, 1)], [(0, 1), (1, 1)],
    [(1, 1), (2, 1)],
    [(-2, 1), (-1, 1), (0, 1)], [(-1, 1), (0, 1), (1, 1)],
    [(0, 1), (1, 1), (2, 1)],
]

CHUNK_DICT = {
    "B-ADJP": 0, "I-ADJP": 1, "B-ADVP": 2, "I-ADVP": 3, "B-CONJP": 4,
    "I-CONJP": 5, "B-INTJ": 6, "I-INTJ": 7, "B-LST": 8, "I-LST": 9,
    "B-NP": 10, "I-NP": 11, "B-PP": 12, "I-PP": 13, "B-PRT": 14,
    "I-PRT": 15, "B-SBAR": 16, "I-SBAR": 17, "B-UCP": 18, "I-UCP": 19,
    "B-VP": 20, "I-VP": 21, "O": 22,
}


def _iter_sequences(path: str):
    seq: List[List[str]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if seq:
                    yield seq
                seq = []
                continue
            seq.append(line.split(" "))
    if seq:
        yield seq


def make_features(sequence: List[List[str]]) -> None:
    """Append one combined feature per pattern to every timestep (boundary
    tokens #B{n}/#E{n}, gen_proto_data.py:60)."""
    length = len(sequence)
    num = len(sequence[0])

    def get(pos: int) -> List[str]:
        if pos < 0:
            return [f"#B{-pos}"] * num
        if pos >= length:
            return [f"#E{pos - length + 1}"] * num
        return sequence[pos]

    for i in range(length):
        for pattern in PATTERNS:
            sequence[i].append(
                "/".join(get(i + off)[col] for off, col in pattern)
            )


def create_dictionaries(
    path: str, cutoff: Sequence[int], oov_policy: Sequence[int]
) -> List[Dict[str, int]]:
    counts: List[Dict[str, int]] = [dict() for _ in cutoff]
    for seq in _iter_sequences(path):
        make_features(seq)
        for features in seq:
            assert len(features) == len(counts)
            for i, feat in enumerate(features):
                counts[i][feat] = counts[i].get(feat, 0) + 1
    dicts: List[Dict[str, int]] = []
    for i, cnt in enumerate(counts):
        n = 1 if oov_policy[i] == OOV_POLICY_USE else 0
        d: Dict[str, int] = {}
        for k, v in cnt.items():
            if v >= cutoff[i]:
                d[k] = n
                n += 1
        if oov_policy[i] == OOV_POLICY_USE:
            d["#OOV#"] = 0
        dicts.append(d)
    return dicts


def default_dicts(train_path: str) -> List[Dict[str, int]]:
    """The generator's __main__ defaults: cutoffs [3,1,0]+[3]*19, chunk
    labels pinned to the fixed 23-tag dict (gen_proto_data.py:269-276)."""
    cutoff = [3, 1, 0] + [3] * len(PATTERNS)
    oov = [OOV_POLICY_IGNORE, OOV_POLICY_ERROR, OOV_POLICY_ERROR]
    oov += [OOV_POLICY_IGNORE] * len(PATTERNS)
    dicts = create_dictionaries(train_path, cutoff, oov)
    dicts[2] = dict(CHUNK_DICT)
    return dicts


def gen_proto_shard(
    input_file: str,
    dicts: List[Dict[str, int]],
    oov_policy: Sequence[int],
    output_file: str,
) -> Tuple[int, List[int]]:
    """→ (feature_dim, index_dims); writes the shard (gen_proto_file)."""
    feature_dim = sum(
        len(dicts[i]) for i in range(NUM_ORIGINAL_COLUMNS, len(dicts))
    )
    slot_defs = [SlotDef(VECTOR_SPARSE_NON_VALUE, feature_dim)]
    index_dims = [len(dicts[i]) for i in range(NUM_ORIGINAL_COLUMNS)]
    slot_defs += [SlotDef(INDEX, d) for d in index_dims]

    samples: List[DataSample] = []
    for seq in _iter_sequences(input_file):
        make_features(seq)
        beginning = True
        for features in seq:
            s = DataSample(is_beginning=beginning)
            beginning = False
            for i in range(NUM_ORIGINAL_COLUMNS):
                fid = dicts[i].get(features[i], -1)
                if fid != -1:
                    s.id_slots.append(fid)
                elif oov_policy[i] == OOV_POLICY_IGNORE:
                    s.id_slots.append(0xFFFFFFFF)
                elif oov_policy[i] == OOV_POLICY_ERROR:
                    raise ValueError(f"unknown token {features[i]!r}")
                else:
                    s.id_slots.append(0)
            vec = VectorSlot()
            dim = 0
            for i in range(NUM_ORIGINAL_COLUMNS, len(dicts)):
                fid = dicts[i].get(features[i], -1)
                if fid != -1:
                    vec.ids.append(dim + fid)
                elif oov_policy[i] == OOV_POLICY_ERROR:
                    raise ValueError(f"unknown feature {features[i]!r}")
                elif oov_policy[i] != OOV_POLICY_IGNORE:
                    vec.ids.append(dim)
                dim += len(dicts[i])
            s.vector_slots.append(vec)
            samples.append(s)
    write_shard(output_file, slot_defs, samples)
    return feature_dim, index_dims


def build_chunking_shards(
    train_txt: str, test_txt: str, out_dir: str
) -> Dict[str, object]:
    """Generate train/test shards + file lists the way the reference test
    setup does (CMake runs gen_proto_data.py before test_Trainer)."""
    os.makedirs(out_dir, exist_ok=True)
    dicts = default_dicts(train_txt)
    oov = [OOV_POLICY_IGNORE, OOV_POLICY_ERROR, OOV_POLICY_ERROR]
    oov += [OOV_POLICY_IGNORE] * len(PATTERNS)
    train_bin = os.path.join(out_dir, "trainer", "tests", "train_proto.bin")
    test_bin = os.path.join(out_dir, "trainer", "tests", "test_proto.bin")
    os.makedirs(os.path.dirname(train_bin), exist_ok=True)
    feature_dim, index_dims = gen_proto_shard(train_txt, dicts, oov, train_bin)
    gen_proto_shard(test_txt, dicts, oov, test_bin)
    for lst, target in (
        ("train_files.txt", "trainer/tests/train_proto.bin"),
        ("test_files.txt", "trainer/tests/test_proto.bin"),
    ):
        with open(os.path.join(out_dir, "trainer", "tests", lst), "w") as f:
            f.write(target + "\n")
    return {
        "dir": out_dir,
        "feature_dim": feature_dim,
        "index_dims": index_dims,
    }

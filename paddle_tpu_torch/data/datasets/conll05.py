"""CoNLL-2005 SRL readers (python/paddle/v2/dataset/conll05.py).

Record schema (v2 test()): (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
verb_ids, mark_ids, label_ids) — 8 feature sequences + BIO label sequence,
matching the demo/semantic_role_labeling pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from paddle_tpu_torch.data.datasets import common

WORD_DICT_LEN = 44068
LABEL_DICT_LEN = 106
PRED_DICT_LEN = 3162


def get_dict():
    """(word_dict, verb_dict, label_dict) — synthetic-stable id spaces when
    the LDC-licensed corpus is unavailable (it always is offline)."""
    def synth():
        word_dict = {f"w{i}": i for i in range(2000)}
        verb_dict = {f"v{i}": i for i in range(200)}
        label_dict = {}
        labels = ["O"]
        for tag in ("A0", "A1", "A2", "A3", "A4", "AM-TMP", "AM-LOC", "AM-MNR", "V"):
            labels += ["B-" + tag, "I-" + tag]
        for i, l in enumerate(labels):
            label_dict[l] = i
        return word_dict, verb_dict, label_dict

    return common.fetch_or_synthetic(
        lambda: (_ for _ in ()).throw(common.DownloadUnavailable("conll05 is LDC-licensed")),
        synth,
        "conll05.get_dict",
    )


def get_embedding():
    raise common.DownloadUnavailable("pretrained emb requires network access")


def test():
    word_dict, verb_dict, label_dict = get_dict()
    n_labels = len(label_dict)
    v = len(word_dict)

    def reader():
        rs = common.rng("conll05.test")
        for _ in range(512):
            length = int(rs.randint(5, 30))
            words = rs.randint(0, v, length).tolist()
            verb_pos = int(rs.randint(0, length))
            verb = [words[verb_pos] % len(verb_dict)] * length
            mark = [1 if i == verb_pos else 0 for i in range(length)]

            def ctx(off):
                return [words[min(max(i + off, 0), length - 1)] for i in range(length)]

            # BIO-consistent label path
            labels: List[int] = []
            state = 0
            for i in range(length):
                if i == verb_pos:
                    labels.append(label_dict.get("B-V", 1))
                    state = 0
                elif state == 0 and rs.rand() < 0.3:
                    labels.append(1 + 2 * int(rs.randint(0, (n_labels - 1) // 2)) % (n_labels - 1))
                    state = 1
                else:
                    labels.append(0)
                    state = 0
            yield (words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2), verb, mark, labels)

    return reader

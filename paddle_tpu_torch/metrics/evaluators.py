"""Streaming evaluators (counterpart of `paddle_tpu/metrics/evaluators.py`):
metrics accumulated across batches.

Parity with paddle/gserver/evaluators/Evaluator.h:42 (start/eval/finish,
registry :32) and its registered set: classification_error, seq error, auc,
precision_recall, pnpair, rank auc, chunk F1 (ChunkEvaluator.cpp), sum /
column-sum, CTC edit distance, detection mAP and the printers. Evaluators
run on host numpy over a batch's outputs; the caller copies those off the
device first (the CLI does it once per step, only when a config declares
evaluators), as the reference's kernels produce per-batch stats and its
Evaluator accumulates on the host."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch.core.registry import EVALUATORS


class Evaluator:
    """start() → update(batch fields) per batch → finish() returns the metric."""

    def start(self) -> None:
        raise NotImplementedError

    def update(self, **kw) -> None:
        raise NotImplementedError

    def finish(self) -> float:
        raise NotImplementedError


def _np(x) -> np.ndarray:
    """A numpy array of `x` (an array, a list, or a tensor on any device)."""
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def _mask_flat(values: np.ndarray, lengths: Optional[np.ndarray]):
    """Flatten [B,T,...] with lengths → (flat values, keep mask); or
    (values, None) for non-sequence [B, ...]."""
    if lengths is None:
        return values, None
    b, t = values.shape[:2]
    keep = np.arange(t)[None, :] < lengths[:, None]
    return values.reshape((b * t,) + values.shape[2:]), keep.reshape(-1)


@EVALUATORS.register("classification_error")
class ClassificationErrorEvaluator(Evaluator):
    """classification_error (Evaluator.cpp ClassificationErrorEvaluator)."""

    def start(self):
        self.wrong = 0.0
        self.total = 0.0

    def update(self, output=None, label=None, weight=None, lengths=None, **kw):
        output = np.asarray(output)
        label = np.asarray(label)
        if output.ndim == 3:  # sequence output
            flat, keep = _mask_flat(
                output, np.asarray(lengths) if lengths is not None else None
            )
            pred = flat.reshape((-1,) + flat.shape[-1:]).argmax(-1)
            lab = label.reshape(-1)
            if keep is None:
                keep = np.ones(len(lab), bool)
        else:
            pred = output.argmax(-1)
            lab = label.reshape(-1)
            keep = np.ones(len(lab), bool)
        w = np.asarray(weight).reshape(-1) if weight is not None else np.ones(len(lab))
        self.wrong += float((w * keep * (pred != lab)).sum())
        self.total += float((w * keep).sum())

    def finish(self):
        return self.wrong / max(self.total, 1e-12)


@EVALUATORS.register("seq_error", "sequence_classification_error")
class SequenceErrorEvaluator(Evaluator):
    """Whole-sequence error: a sequence counts wrong if ANY step is wrong."""

    def start(self):
        self.wrong = 0
        self.total = 0

    def update(self, output=None, label=None, lengths=None, **kw):
        output = np.asarray(output)
        label = np.asarray(label)
        pred = output.argmax(-1)
        b, t = pred.shape
        keep = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
        bad = ((pred != label) & keep).any(axis=1)
        self.wrong += int(bad.sum())
        self.total += b

    def finish(self):
        return self.wrong / max(self.total, 1)


@EVALUATORS.register("auc")
class AucEvaluator(Evaluator):
    """Binary AUC via fixed binning (AucEvaluator in Evaluator.cpp uses the
    same discretized approach)."""

    def __init__(self, num_bins: int = 4096):
        self.num_bins = num_bins

    def start(self):
        self.pos = np.zeros(self.num_bins)
        self.neg = np.zeros(self.num_bins)

    def update(self, output=None, label=None, weight=None, **kw):
        output = np.asarray(output)
        p = output[:, 1] if output.ndim == 2 and output.shape[1] == 2 else output.reshape(-1)
        y = np.asarray(label).reshape(-1)
        w = np.asarray(weight).reshape(-1) if weight is not None else np.ones(len(y))
        idx = np.clip((p * self.num_bins).astype(int), 0, self.num_bins - 1)
        np.add.at(self.pos, idx, w * (y == 1))
        np.add.at(self.neg, idx, w * (y != 1))

    def finish(self):
        # sweep thresholds high→low accumulating TP/FP; trapezoid area
        tp = np.cumsum(self.pos[::-1])
        fp = np.cumsum(self.neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return 0.5
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        return float(np.trapezoid(tpr, fpr))


@EVALUATORS.register("precision_recall")
class PrecisionRecallEvaluator(Evaluator):
    """precision_recall (PrecisionRecallEvaluator): per-class + macro stats."""

    def __init__(self, positive_label: Optional[int] = None):
        self.positive_label = positive_label

    def start(self):
        self.tp: Dict[int, float] = {}
        self.fp: Dict[int, float] = {}
        self.fn: Dict[int, float] = {}

    def update(self, output=None, label=None, weight=None, **kw):
        pred = np.asarray(output).argmax(-1).reshape(-1)
        lab = np.asarray(label).reshape(-1)
        w = np.asarray(weight).reshape(-1) if weight is not None else np.ones(len(lab))
        for c in np.unique(np.concatenate([pred, lab])):
            c = int(c)
            self.tp[c] = self.tp.get(c, 0.0) + float((w * ((pred == c) & (lab == c))).sum())
            self.fp[c] = self.fp.get(c, 0.0) + float((w * ((pred == c) & (lab != c))).sum())
            self.fn[c] = self.fn.get(c, 0.0) + float((w * ((pred != c) & (lab == c))).sum())

    def stats(self, c: int):
        tp, fp, fn = self.tp.get(c, 0.0), self.fp.get(c, 0.0), self.fn.get(c, 0.0)
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return prec, rec, f1

    def finish(self):
        if self.positive_label is not None:
            return self.stats(self.positive_label)[2]
        f1s = [self.stats(c)[2] for c in self.tp]
        return float(np.mean(f1s)) if f1s else 0.0


@EVALUATORS.register("pnpair")
class PnpairEvaluator(Evaluator):
    """Positive-negative pair ratio grouped by query id (PnpairEvaluator)."""

    def start(self):
        self.records: List[np.ndarray] = []

    def update(self, output=None, label=None, query_id=None, weight=None, **kw):
        score = np.asarray(output).reshape(-1)
        lab = np.asarray(label).reshape(-1)
        qid = np.asarray(query_id).reshape(-1)
        w = np.asarray(weight).reshape(-1) if weight is not None else np.ones(len(lab))
        self.records.append(np.stack([score, lab, qid, w], 1))

    def finish(self):
        if not self.records:
            return 0.0
        rec = np.concatenate(self.records, 0)
        pos, neg, tie = 0.0, 0.0, 0.0
        for q in np.unique(rec[:, 2]):
            grp = rec[rec[:, 2] == q]
            n = len(grp)
            for i in range(n):
                for j in range(i + 1, n):
                    if grp[i, 1] == grp[j, 1]:
                        continue
                    w = grp[i, 3] + grp[j, 3]
                    hi, lo = (i, j) if grp[i, 1] > grp[j, 1] else (j, i)
                    if grp[hi, 0] > grp[lo, 0]:
                        pos += w
                    elif grp[hi, 0] < grp[lo, 0]:
                        neg += w
                    else:
                        tie += w
        return (pos + 0.5 * tie) / max(pos + neg + tie, 1e-12)


RankAucEvaluator = PnpairEvaluator


@EVALUATORS.register("sum")
class SumEvaluator(Evaluator):
    def start(self):
        self.total = 0.0

    def update(self, output=None, weight=None, **kw):
        v = np.asarray(output)
        if weight is not None:
            v = v * np.asarray(weight).reshape((-1,) + (1,) * (v.ndim - 1))
        self.total += float(v.sum())

    def finish(self):
        return self.total


@EVALUATORS.register("column_sum")
class ColumnSumEvaluator(Evaluator):
    def start(self):
        self.total = None
        self.n = 0.0

    def update(self, output=None, **kw):
        v = np.asarray(output).reshape(-1, np.asarray(output).shape[-1])
        s = v.sum(0)
        self.total = s if self.total is None else self.total + s
        self.n += v.shape[0]

    def finish(self):
        return self.total / max(self.n, 1.0)


@EVALUATORS.register("chunk")
class ChunkEvaluator(Evaluator):
    """Chunk-level F1 for sequence labeling (ChunkEvaluator.cpp). Supports the
    same schemes: IOB/IOE/IOBES/plain with num_chunk_types."""

    def __init__(self, scheme: str = "IOB", num_chunk_types: int = 1,
                 excluded_chunk_types=()):
        assert scheme in ("IOB", "IOE", "IOBES", "plain")
        self.scheme = scheme
        self.num_chunk_types = num_chunk_types
        self.excluded = set(excluded_chunk_types or ())

    def start(self):
        self.correct = 0
        self.n_pred = 0
        self.n_label = 0

    def _extract(self, tags: np.ndarray):
        """tag ids → set of (start, end, type) chunks."""
        chunks = []
        start = None
        cur_type = None
        scheme = self.scheme
        n_tag_types = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
        other = n_tag_types * self.num_chunk_types  # the "O" tag id
        for i, t in enumerate(list(tags) + [other]):
            t = int(t)
            if t == other:
                pos, typ = None, None
            else:
                pos, typ = t % n_tag_types, t // n_tag_types
            if scheme == "plain":
                is_start = typ is not None and typ != cur_type
                ends_prev = typ != cur_type
            elif scheme == "IOB":
                is_start = typ is not None and (pos == 0 or typ != cur_type)
                ends_prev = typ is None or pos == 0 or typ != cur_type
            elif scheme == "IOE":
                # pos 0 = I, 1 = E(end)
                is_start = typ is not None and cur_type is None
                ends_prev = typ is None or typ != cur_type
            else:  # IOBES: 0=B 1=I 2=E 3=S
                is_start = typ is not None and pos in (0, 3)
                ends_prev = typ is None or pos in (0, 3)
            if start is not None and ends_prev:
                chunks.append((start, i - 1, cur_type))
                start, cur_type = None, None
            if typ is not None and is_start:
                start, cur_type = i, typ
            elif typ is not None and start is None:
                start, cur_type = i, typ
            if scheme == "IOBES" and typ is not None and pos in (2, 3):
                chunks.append((start, i, cur_type))
                start, cur_type = None, None
            if scheme == "IOE" and typ is not None and pos == 1:
                chunks.append((start, i, cur_type))
                start, cur_type = None, None
        # chunk of these types are not counted (ModelConfig.proto:561)
        return {c for c in chunks if c[2] not in self.excluded}

    def update(self, output=None, label=None, lengths=None, **kw):
        pred = np.asarray(output)
        if pred.ndim == 3:
            pred = pred.argmax(-1)
        lab = np.asarray(label)
        lens = np.asarray(lengths) if lengths is not None else [pred.shape[1]] * pred.shape[0]
        for i in range(pred.shape[0]):
            p_chunks = self._extract(pred[i, : lens[i]])
            l_chunks = self._extract(lab[i, : lens[i]])
            self.correct += len(p_chunks & l_chunks)
            self.n_pred += len(p_chunks)
            self.n_label += len(l_chunks)

    def finish(self):
        prec = self.correct / max(self.n_pred, 1e-12)
        rec = self.correct / max(self.n_label, 1e-12)
        return 2 * prec * rec / max(prec + rec, 1e-12)


def _edit_distance(a, b) -> int:
    """Levenshtein distance between two id sequences (host-side numpy DP —
    same role as CTCErrorEvaluator.cpp's per-pair editDistance)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev = np.arange(lb + 1)
    for i in range(1, la + 1):
        cur = np.empty(lb + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (0 if a[i - 1] == b[j - 1] else 1),
            )
        prev = cur
    return int(prev[lb])


@EVALUATORS.register("ctc_edit_distance", "ctc_error")
class CTCErrorEvaluator(Evaluator):
    """Sequence error rate of the CTC best path vs the gold label sequence
    (CTCErrorEvaluator.cpp): sum(edit_distance) / sum(label_len).

    update() takes either pre-decoded ids (`decoded`, -1-padded, from
    ops.ctc.ctc_greedy_decode) or raw `output` logits [B, T, C] which are
    greedy-decoded on host."""

    def start(self):
        self.total_dist = 0
        self.total_len = 0

    def update(
        self,
        label=None,
        label_lengths=None,
        decoded=None,
        output=None,
        lengths=None,
        blank=0,
        **kw,
    ):
        lab = np.asarray(label)
        lab_lens = (
            np.asarray(label_lengths)
            if label_lengths is not None
            else np.full(lab.shape[0], lab.shape[1])
        )
        if decoded is None:
            logits = np.asarray(output)
            lens = (
                np.asarray(lengths)
                if lengths is not None
                else np.full(logits.shape[0], logits.shape[1])
            )
            rows = []
            for i in range(logits.shape[0]):
                ids = logits[i, : lens[i]].argmax(-1)
                if len(ids) == 0:
                    rows.append(ids)
                    continue
                keep = np.concatenate([[True], ids[1:] != ids[:-1]])
                ids = ids[keep]
                rows.append(ids[ids != blank])
            dec_rows = rows
        else:
            dec = np.asarray(decoded)
            dec_rows = [row[row >= 0] for row in dec]
        for i, d in enumerate(dec_rows):
            g = lab[i, : lab_lens[i]]
            self.total_dist += _edit_distance(list(d), list(g))
            self.total_len += len(g)

    def finish(self):
        return self.total_dist / max(self.total_len, 1e-12)


@EVALUATORS.register("detection_map")
class DetectionMAPEvaluator(Evaluator):
    """Mean average precision over detection outputs
    (DetectionMAPEvaluator.cpp), on the host in numpy: per-class scored
    TP/FP marks accumulate across batches, then AP per class by the
    11-point or the integral rule, averaged over the classes that have
    ground truth.

    update(detections=[B, K, 6] rows (label, score, xmin, ymin, xmax, ymax;
    score 0 is padding), gt_boxes=[B, G, 4], gt_labels=[B, G],
    gt_lengths=[B]): the padded form of the reference's sequence label
    input. A detection is a true positive when it overlaps a still
    unclaimed gt box of its class by at least `overlap_threshold`."""

    def __init__(self, overlap_threshold=0.5, ap_type="11point", background_id=0):
        self.overlap_threshold = overlap_threshold
        self.ap_type = ap_type
        self.background_id = background_id

    def start(self):
        self.marks = {}  # class -> [(score, is_tp)]
        self.n_gt = {}  # class -> count

    @staticmethod
    def _iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.maximum(rb - lt, 0.0)
        inter = wh[0] * wh[1]
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
        ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
        return inter / max(ua + ub - inter, 1e-12)

    def update(self, detections=None, gt_boxes=None, gt_labels=None, gt_lengths=None, **kw):
        det = _np(detections)
        gtb = _np(gt_boxes)
        gtl = _np(gt_labels)
        lens = (_np(gt_lengths) if gt_lengths is not None
                else np.full(gtb.shape[0], gtb.shape[1]))
        for i in range(det.shape[0]):
            gts = gtb[i, :lens[i]]
            gls = gtl[i, :lens[i]]
            for c in np.unique(gls):
                if c == self.background_id:
                    continue
                self.n_gt[int(c)] = self.n_gt.get(int(c), 0) + int((gls == c).sum())
            used = np.zeros(len(gts), bool)
            rows = det[i]
            rows = rows[rows[:, 1] > 0]
            rows = rows[np.argsort(-rows[:, 1])]
            for row in rows:
                c, score, box = int(row[0]), float(row[1]), row[2:6]
                best_j, best_iou = -1, self.overlap_threshold
                for j in np.where((gls == c) & ~used)[0]:
                    v = self._iou(box, gts[j])
                    if v >= best_iou:
                        best_j, best_iou = j, v
                if best_j >= 0:
                    used[best_j] = True
                self.marks.setdefault(c, []).append((score, best_j >= 0))

    def finish(self):
        aps = []
        for c, n_pos in self.n_gt.items():
            marks = sorted(self.marks.get(c, []), key=lambda t: -t[0])
            if n_pos == 0:
                continue
            if not marks:
                aps.append(0.0)
                continue
            tps = np.cumsum([m[1] for m in marks])
            fps = np.cumsum([not m[1] for m in marks])
            recall = tps / n_pos
            precision = tps / np.maximum(tps + fps, 1e-12)
            ap = 0.0
            if self.ap_type == "11point":
                for r in np.linspace(0, 1, 11):
                    p = precision[recall >= r].max() if (recall >= r).any() else 0.0
                    ap += p / 11.0
            else:  # integral
                prev_r = 0.0
                for k in range(len(marks)):
                    ap += precision[k] * (recall[k] - prev_r)
                    prev_r = recall[k]
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0


@EVALUATORS.register("value_printer")
class ValuePrinter(Evaluator):
    """Utility evaluator (Evaluator.cpp ValuePrinter): logs layer outputs
    each batch — the debugging role of the reference printer evaluators."""

    def __init__(self, writer=None, **_kw):
        import sys

        self._write = writer or (lambda s: sys.stderr.write(s + "\n"))

    def start(self):
        self.batches = 0

    def update(self, **kw):
        self.batches += 1
        for k, v in kw.items():
            if v is None:
                continue
            arr = np.asarray(v)
            with np.printoptions(threshold=64, precision=6):
                self._write(f"[value_printer] {k}: shape={arr.shape} {arr}")

    def finish(self):
        return float(self.batches)


@EVALUATORS.register("gradient_printer")
class GradientPrinter(ValuePrinter):
    """GradientPrinter declaration compatibility. Per-layer gradients never
    leave the compiled step here (autodiff inside jit), so this prints the
    forward value and says so — the config keeps parsing and running."""

    def update(self, **kw):
        self.batches += 1
        for k, v in kw.items():
            if v is None:
                continue
            arr = np.asarray(v)
            with np.printoptions(threshold=64, precision=6):
                self._write(
                    f"[gradient_printer] {k} (forward value; grads stay "
                    f"inside the compiled step): shape={arr.shape} {arr}"
                )


@EVALUATORS.register("max_id_printer")
class MaxIdPrinter(ValuePrinter):
    """utils max_id printer: top-k argmax ids of the output distribution."""

    def __init__(self, num_results: int = 1, writer=None, **_kw):
        super().__init__(writer)
        self.k = max(1, int(num_results))

    def update(self, output=None, **kw):
        if output is None:
            return
        self.batches += 1
        arr = np.asarray(output)
        flat = arr.reshape(-1, arr.shape[-1])
        top = np.argsort(-flat, axis=-1)[:, : self.k]
        self._write(f"[max_id_printer] top{self.k} ids: {top[:8].tolist()}")


@EVALUATORS.register("classification_error_printer")
class ClassificationErrorPrinter(ValuePrinter):
    """Prints the per-example 0/1 error vector (utils printer parity)."""

    def update(self, output=None, label=None, **kw):
        if output is None or label is None:
            return
        self.batches += 1
        pred = np.asarray(output).reshape(-1, np.asarray(output).shape[-1]).argmax(-1)
        lab = np.asarray(label).reshape(-1)
        err = (pred != lab[: len(pred)]).astype(np.int32)
        self._write(f"[classification_error_printer] err={err[:32].tolist()}")


@EVALUATORS.register("seq_text_printer")
class SequenceTextPrinter(Evaluator):
    """seqtext_printer_evaluator → SequenceTextPrinter (Evaluator.cpp:1192):
    dump generated sequences to `result_file`, byte-compatible with the
    reference's three output shapes — plain per-sample lines, beam blocks
    (`sample\\n rank\\tscore\\t toks...` per result, Evaluator.cpp:1303 beam
    print), and nested per-subsequence lines (Evaluator.cpp:1286)."""

    def __init__(self, result_file: str, dict_file: str = "",
                 delimited: bool = True, **_kw):
        self.result_file = result_file
        self.delimited = delimited
        self.dict: list = []
        if dict_file:
            with open(dict_file) as f:
                self.dict = [line.rstrip("\n") for line in f]
        self._fh = None

    def start(self):
        self._fh = open(self.result_file, "w")

    def _toks(self, ids) -> str:
        sep = " " if self.delimited else ""
        return "".join(
            sep + (self.dict[int(i)] if self.dict else str(int(i)))
            for i in ids
        )

    def _fmt_score(self, v: float) -> str:
        # C++ default ostream float formatting (6 significant digits)
        return f"{float(v):g}"

    def update(self, output=None, sample_ids=None, beam=None, lengths=None,
               sub_lengths=None, **_kw):
        """output: [B, L] best-beam ids (or [B, S, L] nested); lengths [B]
        (valid subsequence count when nested); sub_lengths [B, S] per-subseq
        token counts; beam: the generation payload cached by BeamSearchLayer
        {history [B,K,L], scores [B,K], lengths [B,K], num_results}."""
        out = self._fh
        values = None if output is None else np.asarray(output)
        beam_mode = beam is not None and int(beam.get("num_results", 1)) > 1
        if values is None and beam is not None and not beam_mode:
            # best-beam fallback when the caller hands only the payload
            values = np.asarray(beam["history"])[:, 0]
            lengths = np.asarray(beam["lengths"])[:, 0]
        nested = values is not None and values.ndim == 3
        if beam_mode:
            all_hist = np.asarray(beam["history"])
            all_scores = np.asarray(beam["scores"])
            all_lens = np.asarray(beam["lengths"])
            n = len(all_hist)
        elif values is None:
            raise ValueError(
                "SequenceTextPrinter.update needs `output` ids or a beam "
                "payload with history/lengths; got neither — is the "
                "evaluator's input layer among the network outputs?"
            )
        else:
            n = len(values)
        ids_flat = (
            None if sample_ids is None else np.asarray(sample_ids).reshape(-1)
        )
        lengths = None if lengths is None else np.asarray(lengths)
        sub_lengths = None if sub_lengths is None else np.asarray(sub_lengths)
        for i in range(n):
            sid = i if ids_flat is None else int(ids_flat[i])
            out.write(str(sid))
            # each sample ends with the evalImp loop's final endl; in plain
            # mode it terminates the line, in beam/nested modes (whose inner
            # lines carry their own endl) it yields the blank separator line
            if beam_mode:
                hist, scores, lens = all_hist[i], all_scores[i], all_lens[i]
                out.write("\n")
                for j in range(int(beam["num_results"])):
                    out.write(f"{j}\t{self._fmt_score(scores[j])}\t")
                    out.write(self._toks(hist[j, : lens[j]]) + "\n")
            elif nested:
                n_sub = int(lengths[i]) if lengths is not None else values.shape[1]
                sl = sub_lengths[i] if sub_lengths is not None else None
                for s in range(n_sub):
                    t = int(sl[s]) if sl is not None else values.shape[2]
                    out.write("\t" + self._toks(values[i, s, :t]) + "\n")
            else:
                t = int(lengths[i]) if lengths is not None else values.shape[1]
                out.write("\t" + self._toks(values[i, :t]))
            out.write("\n")

    def finish(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        return 0.0

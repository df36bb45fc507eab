"""Evaluator classes (counterpart of paddle_tpu/evaluator.py; fluid's
evaluator.py): ``ChunkEvaluator``, ``EditDistance`` and ``DetectionMAP``.

They keep their running state on the host and take the per-batch
outputs of ``layers.chunk_eval``, ``layers.edit_distance`` or detection
predictions fetched from ``Executor.run``, as the JAX package's do: the
reference's accumulator variables and reset programs would add ops to a
step that the card replays from one CUDA graph.
"""
import numpy as np

__all__ = ['ChunkEvaluator', 'EditDistance', 'DetectionMAP']


class Evaluator(object):
    """Base: host-state accumulators with the reference's
    reset()/eval() surface (ref evaluator.py:45)."""

    def __init__(self, name=None, **kwargs):
        self.helper_name = name or self.__class__.__name__
        self.states = {}

    def reset(self, executor=None, reset_program=None):
        for k in self.states:
            self.states[k] = 0.0

    def eval(self, executor=None, eval_program=None):
        raise NotImplementedError()


class ChunkEvaluator(Evaluator):
    """Accumulate chunk_eval batch counts into corpus-level
    precision/recall/F1 (ref evaluator.py:127).  Feed it the three
    count outputs of ``layers.chunk_eval`` each batch via update()."""

    def __init__(self, input=None, label=None, chunk_scheme=None,
                 num_chunk_types=None, excluded_chunk_types=None):
        super(ChunkEvaluator, self).__init__()
        self.states = {"num_infer_chunks": 0.0, "num_label_chunks": 0.0,
                       "num_correct_chunks": 0.0}

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.states["num_infer_chunks"] += float(
            np.asarray(num_infer_chunks).reshape(-1)[0])
        self.states["num_label_chunks"] += float(
            np.asarray(num_label_chunks).reshape(-1)[0])
        self.states["num_correct_chunks"] += float(
            np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self, executor=None, eval_program=None):
        c = self.states["num_correct_chunks"]
        i = self.states["num_infer_chunks"]
        l = self.states["num_label_chunks"]
        precision = c / i if i else 0.0
        recall = c / l if l else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return precision, recall, f1


class EditDistance(Evaluator):
    """Average edit distance + sequence error rate accumulator
    (ref evaluator.py:218): update() with the per-batch (distances,
    seq_num) from ``layers.edit_distance``."""

    def __init__(self, input=None, label=None, ignored_tokens=None):
        super(EditDistance, self).__init__()
        self.states = {"total_distance": 0.0, "seq_num": 0.0,
                       "instance_error": 0.0}

    def update(self, distances, seq_num=None):
        d = np.asarray(distances).reshape(-1)
        self.states["total_distance"] += float(d.sum())
        self.states["seq_num"] += float(len(d) if seq_num is None
                                        else np.asarray(seq_num)
                                        .reshape(-1)[0])
        self.states["instance_error"] += float((d > 0).sum())

    def eval(self, executor=None, eval_program=None):
        n = self.states["seq_num"]
        avg = self.states["total_distance"] / n if n else 0.0
        err = self.states["instance_error"] / n if n else 0.0
        return avg, err


def _voc_ap(rec, prec, use_11_point):
    if use_11_point:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return min(ap, 1.0)  # guard float accumulation past 1.0
    # integral AP: area under the monotone precision envelope
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class DetectionMAP(Evaluator):
    """VOC-style mean average precision accumulator
    (ref evaluator.py:299 + operators/detection_map_op).  update() per
    image with predictions [[label, score, x1, y1, x2, y2], ...] and
    ground truths [[label, x1, y1, x2, y2], ...] (+ optional difficult
    flags); eval() returns mAP over all updates."""

    def __init__(self, input=None, gt_label=None, gt_box=None,
                 gt_difficult=None, class_num=None,
                 background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version='integral'):
        super(DetectionMAP, self).__init__()
        if ap_version not in ('integral', '11point'):
            raise ValueError("ap_version must be 'integral' or '11point'")
        self.class_num = class_num
        self.background_label = background_label
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self._preds = {}   # class -> list of (score, image_id, box)
        self._gts = {}     # (image_id, class) -> [ [box, difficult, hit] ]
        self._img = 0

    def reset(self, executor=None, reset_program=None):
        self._preds, self._gts, self._img = {}, {}, 0

    def update(self, predictions, gt_boxes, gt_labels, difficult=None):
        img = self._img
        self._img += 1
        preds = np.asarray(predictions, np.float64).reshape(-1, 6)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        if difficult is None:
            difficult = np.zeros(len(gt_labels), bool)
        difficult = np.asarray(difficult).reshape(-1).astype(bool)
        for box, lab, diff in zip(gt_boxes, gt_labels, difficult):
            self._gts.setdefault((img, int(lab)), []).append(
                [box, bool(diff), False])
        for row in preds:
            lab = int(row[0])
            if lab == self.background_label or lab < 0:
                continue
            self._preds.setdefault(lab, []).append(
                (float(row[1]), img, row[2:6]))

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = (a[2] - a[0]) * (a[3] - a[1]) + \
            (b[2] - b[0]) * (b[3] - b[1]) - inter
        return inter / ua if ua > 0 else 0.0

    def eval(self, executor=None, eval_program=None):
        classes = set(self._preds) | {c for (_, c) in self._gts}
        classes.discard(self.background_label)
        aps = []
        for c in sorted(classes):
            npos = 0
            for (img, cc), entries in self._gts.items():
                if cc != c:
                    continue
                for e in entries:
                    e[2] = False  # reset hit marks
                    if self.evaluate_difficult or not e[1]:
                        npos += 1
            dets = sorted(self._preds.get(c, []), reverse=True,
                          key=lambda r: r[0])
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (score, img, box) in enumerate(dets):
                cands = self._gts.get((img, c), [])
                best, best_iou = None, self.overlap_threshold
                for e in cands:
                    iou = self._iou(box, e[0])
                    if iou >= best_iou:
                        best, best_iou = e, iou
                if best is None:
                    fp[i] = 1
                elif not self.evaluate_difficult and best[1]:
                    continue  # difficult gt: ignore the detection
                elif not best[2]:
                    tp[i] = 1
                    best[2] = True
                else:
                    fp[i] = 1  # duplicate detection of a matched gt
            if npos == 0:
                continue
            rec = np.cumsum(tp) / npos
            prec = np.cumsum(tp) / np.maximum(
                np.cumsum(tp) + np.cumsum(fp), 1e-12)
            aps.append(_voc_ap(rec, prec,
                               self.ap_version == '11point'))
        return float(np.mean(aps)) if aps else 0.0

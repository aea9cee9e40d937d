"""Host-side streaming metrics.  Reference:
python/paddle/fluid/metrics.py.

numpy only: the port keeps its own copy of the JAX package's
fluid/metrics.py, so the two accumulate alike (Accuracy takes the
fetched accuracy of each batch with the batch's size as its weight)."""

import numpy as np


class MetricBase(object):
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError('Accuracy: no updates yet')
        return self.value / self.weight


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels != 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds != 1) & (labels == 1)))

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(MetricBase):
    def __init__(self, name=None, curve='ROC', num_thresholds=4095):
        super(Auc, self).__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        p = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bucket = np.clip((p * self._num_thresholds).astype(np.int64), 0,
                         self._num_thresholds)
        for b, l in zip(bucket, labels):
            if l > 0:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / max(tp[-1], 1)
        fpr = fp / max(fp[-1], 1)
        return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) * 0.5))


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = self.num_correct_chunks / max(self.num_infer_chunks, 1)
        recall = self.num_correct_chunks / max(self.num_label_chunks, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-6)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Reference fluid/metrics.py EditDistance: accumulates the
    edit_distance op's per-batch distances + sequence-error counts."""

    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances, 'float32').ravel()
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError('no data in EditDistance')
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error

    def reset(self):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0


class DetectionMAP(object):
    """Reference fluid/metrics.py DetectionMAP (simplified 11-point /
    integral VOC mAP over host-side accumulated detections)."""

    def __init__(self, input=None, gt_label=None, gt_box=None,
                 gt_difficult=None, class_num=None,
                 background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version='integral'):
        self.class_num = class_num
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.background_label = background_label
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._dets = []
        self._gts = []

    def update(self, detections, gt_boxes, gt_labels):
        """detections: [[label, score, x1,y1,x2,y2], ...] per image."""
        self._dets.append(np.asarray(detections, 'float32'))
        self._gts.append((np.asarray(gt_boxes, 'float32'),
                          np.asarray(gt_labels).ravel()))

    @staticmethod
    def _iou(a, b):
        iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = iw * ih
        ua = ((a[2] - a[0]) * (a[3] - a[1]) +
              (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def eval(self, executor=None):
        aps = []
        for c in range(self.class_num or 1):
            if c == self.background_label:
                continue
            scores, matches, n_gt = [], [], 0
            for dets, (boxes, labels) in zip(self._dets, self._gts):
                gt_idx = np.where(labels == c)[0]
                n_gt += len(gt_idx)
                used = set()
                cdets = [d for d in dets if len(d) >= 6 and
                         int(d[0]) == c]
                for d in sorted(cdets, key=lambda r: -r[1]):
                    best, bi = 0.0, -1
                    for gi in gt_idx:
                        if gi in used:
                            continue
                        i = self._iou(d[2:6], boxes[gi])
                        if i > best:
                            best, bi = i, gi
                    ok = best >= self.overlap_threshold
                    if ok:
                        used.add(bi)
                    scores.append(d[1])
                    matches.append(1.0 if ok else 0.0)
            if n_gt == 0 or not scores:
                continue
            order = np.argsort(-np.asarray(scores))
            tp = np.cumsum(np.asarray(matches)[order])
            fp = np.cumsum(1.0 - np.asarray(matches)[order])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1e-9)
            if self.ap_version == '11point':
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)])
            else:
                # integrate precision over recall from 0 (a single
                # det still integrates to its precision)
                r = np.concatenate([[0.0], rec])
                p = np.concatenate([[prec[0]], prec])
                trap = getattr(np, 'trapezoid', None) or np.trapz
                ap = float(trap(p, r))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0

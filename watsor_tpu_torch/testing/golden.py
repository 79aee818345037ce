# Copy of watsor_tpu/testing/golden.py: the record matching only (the rest
# of that module builds JAX detectors).
"""Detections as records and the matching rule of the goldens: the same
label, IoU above a threshold and a close score."""


def detections_to_records(boxes, scores, classes, valid, top=8,
                          score_floor=0.0):
    """Per-image list of {label, score, box} for the top-k detections."""
    records = []
    for i in range(boxes.shape[0]):
        n = int(valid[i])
        rows = [r for r in range(n) if scores[i, r] > score_floor]
        rows.sort(key=lambda r: -float(scores[i, r]))
        records.append([
            {'label': int(classes[i, r]),
             'score': round(float(scores[i, r]), 6),
             'box': [round(float(v), 6) for v in boxes[i, r]]}
            for r in rows[:top]])
    return records
def iou(a, b):
    """IoU of two [ymin, xmin, ymax, xmax] boxes."""
    yi0, xi0 = max(a[0], b[0]), max(a[1], b[1])
    yi1, xi1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, yi1 - yi0) * max(0.0, xi1 - xi0)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def match_records(expected, got, iou_threshold=0.5, score_tol=5e-3):
    """Every expected detection must have a counterpart in ``got`` with the
    same label, IoU above threshold, and a close score. Returns a list of
    human-readable mismatch strings (empty = pass)."""
    problems = []
    for e in expected:
        candidates = [g for g in got if g['label'] == e['label']
                      and iou(e['box'], g['box']) > iou_threshold]
        if not candidates:
            problems.append(
                'no detection matches label={} box={} (have {})'.format(
                    e['label'], e['box'],
                    [(g['label'], [round(v, 3) for v in g['box']])
                     for g in got]))
            continue
        best = min(candidates, key=lambda g: abs(g['score'] - e['score']))
        if score_tol is not None and \
                abs(best['score'] - e['score']) > score_tol:
            problems.append(
                'score drift for label={}: expected {} got {}'.format(
                    e['label'], e['score'], best['score']))
    return problems

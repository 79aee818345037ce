"""The comparison that decides ``correct``: what the program served for a
sample of the window's frames against the reference's work on the same
frames, weights and camera rules.

Which anchors enter a frame's NMS union (its best ``union`` by best
watched logit, of tens of thousands) is decided by logits packed close
near the union's cut, where rounding the forward to bf16 reorders them.
So the first two numbers hold only the detections whose logit clears the
reference's cut by the configuration's ``union_margin`` (logit units,
more than bf16 rounding moves a logit there): confident detections, which
any sound run's union holds.

Three numbers, each with its limit from the configuration's file:

- ``cand_gap``: for each confident detection the program served (its
  score's logit clearing the reference's cut by the margin), the distance
  to the nearest of the reference's candidates of its label (the decoded
  box and sigmoid score of the best anchors by best watched logit, twice
  as many as the NMS union holds), as the largest of the four box
  coordinates' and the score's differences; the largest over the sample
  (a widest gap). It holds the forward, the decoding and the transport of
  each answer.
- ``unmatched_share``: of the confident detections that either side
  serves in the sample, the share that the other side does not report:
  none of its served detections of that label overlaps it by more than
  the suppression's IoU threshold with a score within the configuration's
  ``score_tolerance``. It holds the suppression, the merge and the filters
  to the whole answer, a detection missed as much as one too many,
  whichever of two overlapping near-tied boxes the suppression kept.
- ``rule_breaks``: served detections that break a rule the answer keeps
  whatever the precision, checked on the program's own numbers: a watched
  label, the camera's confidence and area, the camera's zones by the
  exact pixel test, the zone bits equal to the exact hits (none without a
  mask), no two boxes of a label overlapping by more than the
  suppression's threshold (beyond f32 rounding), the valid count equal to
  the served rows, at most max_detections. Its limit is 0.
"""

import numpy as np
import torch

from benchmark.lib import post

# IoU computed in another order of f32 operations differs by rounding
IOU_ROUNDING = 1e-6
# candidates a frame, in NMS unions: rounding moves an anchor's rank in
# the union by some tens at most
CANDIDATES = 2


def served(result, row):
    """One frame of a resolved batch: (boxes, scores, labels, zone bits,
    valid) of its served rows (score above 0), as the application's
    scatter takes them."""
    boxes, scores, classes, valid = result[:4]
    zones = result[5] if len(result) > 5 else None
    rows = np.nonzero(scores[row] > 0.0)[0]
    z = zones[row, rows] if zones is not None else \
        np.zeros((len(rows), 0), bool)
    return (boxes[row, rows].astype(np.float32),
            scores[row, rows].astype(np.float32),
            classes[row, rows].astype(np.int64), z, int(valid[row]))


def rule_breaks(frame, camera, labels, cfg):
    """The rules ``frame`` (as ``served`` gives it) breaks for
    ``camera`` (a post.CameraFilter)."""
    boxes, scores, got, zbits, valid = frame
    breaks = int(valid != len(scores)) + int(len(scores) >
                                             cfg['max_detections'])
    finite = np.isfinite(boxes).all(1) & np.isfinite(scores) & \
        (scores <= 1.0)
    breaks += int((~finite).sum())
    keep, hits = camera.admits(boxes, scores, got)
    breaks += int((~keep).sum())
    width = zbits.shape[1] if zbits.ndim == 2 else 0
    want = np.zeros((len(scores), max(width, hits.shape[1])), bool)
    want[:, :hits.shape[1]] = hits
    have = np.zeros_like(want)
    have[:, :width] = zbits
    breaks += int((want != have).any(1).sum())
    for label in labels:
        rows = np.nonzero(got == label)[0]
        if len(rows) > 1:
            b = torch.from_numpy(boxes[rows])
            over = post.iou(b, b) > cfg['iou_threshold'] + IOU_ROUNDING
            breaks += int(torch.triu(over, 1).sum())
    return breaks


def logit(scores):
    """The logit of each sigmoid score (float64; a score of 1 is inf)."""
    p = np.asarray(scores, np.float64)
    with np.errstate(divide='ignore'):
        return np.log(p) - np.log1p(-p)


def confident(frame, cut):
    """``frame`` (as ``served`` gives it) cut to its rows whose score's
    logit is at least ``cut``."""
    keep = logit(frame[1]) >= cut
    return tuple(x[keep] for x in frame[:4]) + (int(keep.sum()),)


def nearest(frame, cands, labels):
    """Each served detection's distance to its nearest candidate of its
    label [n]: ``cands`` = (boxes [K, 4], scores [K, C]) on the device."""
    boxes, scores, got = frame[0], frame[1], frame[2]
    cand_boxes, cand_scores = cands
    out = []
    for column, label in enumerate(labels):
        rows = np.nonzero(got == label)[0]
        if not len(rows):
            continue
        b = torch.from_numpy(boxes[rows]).to(cand_boxes.device)
        s = torch.from_numpy(scores[rows]).to(cand_boxes.device)
        dist = torch.maximum(
            (b[:, None, :] - cand_boxes[None]).abs().amax(-1),
            (s[:, None] - cand_scores[None, :, column]).abs())
        out.append(dist.amin(1).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def missed(frame, due, threshold, score_tolerance):
    """How many of the detections ``due`` = (boxes, scores, labels) the
    side that served ``frame`` (boxes, scores, labels, ...) reports no
    object for: no detection of that label whose box overlaps it by more
    than ``threshold`` IoU with a score within ``score_tolerance``."""
    boxes, scores, got = frame[0], frame[1], frame[2]
    rb, rs, rl = due
    if not len(rs):
        return 0
    if not len(scores):
        return len(rs)
    over = post.iou(torch.from_numpy(rb), torch.from_numpy(boxes)).numpy()
    hit = (over > threshold) & (rl[:, None] == got[None, :])
    hit &= np.abs(rs[:, None] - scores[None, :]) <= score_tolerance
    return int((~hit.any(1)).sum())


def compare(frames, cameras, inputs, reference, cfg, filters, block=16):
    """The three numbers over the sample: ``frames`` as ``served`` gives
    them, ``cameras`` their senders, ``inputs`` the uint8 frames [n, S, S,
    3] (numpy), ``reference`` = (raw forward, anchors [A, 4] tensor,
    columns, device); ``filters`` {camera: post.CameraFilter}. The
    reference runs ``block`` frames at a time. Returns ({name: {'value',
    'limit'}} of the numbers the configuration's ``limits`` name, {name:
    value} of readings not compared: the widest gap of every served
    detection to every anchor's candidate, the confident gaps' 99th
    percentile, the detections and the confident ones served a frame by
    each side)."""
    forward, anchors, columns, device = reference
    labels = post.watched_labels(cfg)
    gaps, gaps_every, breaks = [], [], 0
    unmatched = served_ref = served_prog = sure_ref = sure_prog = 0
    for start in range(0, len(frames), block):
        x = torch.from_numpy(inputs[start:start + block]).to(device).float()
        box_enc, logits = forward(x)
        cands, dets, cuts = post.detect(box_enc, logits, anchors, cfg,
                                        columns, labels, CANDIDATES)
        db, ds, dl = (t.cpu().numpy() for t in dets)
        cuts = cuts.cpu().numpy().astype(np.float64) + cfg['union_margin']
        for i in range(len(x)):
            frame = frames[start + i]
            camera = filters[cameras[start + i]]
            breaks += rule_breaks(frame, camera, labels, cfg)
            rows = np.nonzero(ds[i] > 0)[0]
            keep, _ = camera.admits(db[i, rows], ds[i, rows], dl[i, rows])
            rows = rows[keep]
            sure = confident(frame, cuts[i])
            gaps.append(nearest(sure, (cands[0][i], cands[1][i]), labels))
            every = (post.decode(box_enc[i], anchors,
                                 cfg['box_coder_scales']),
                     torch.sigmoid(logits[i][:, columns]))
            gaps_every.append(nearest(frame, every, labels))
            ref = (db[i, rows], ds[i, rows], dl[i, rows])
            due = rows[logit(ds[i, rows]) >= cuts[i]]
            unmatched += missed(frame, (db[i, due], ds[i, due], dl[i, due]),
                                cfg['iou_threshold'], cfg['score_tolerance'])
            unmatched += missed(ref, sure[:3], cfg['iou_threshold'],
                                cfg['score_tolerance'])
            served_ref += len(rows)
            served_prog += len(frame[1])
            sure_ref += len(due)
            sure_prog += sure[4]
    gaps = np.concatenate(gaps) if gaps else np.zeros(0)
    values = {'cand_gap': float(gaps.max(initial=0.0)),
              'unmatched_share': unmatched / max(sure_ref + sure_prog, 1),
              'rule_breaks': breaks}
    n = max(len(frames), 1)
    every = np.concatenate(gaps_every) if gaps_every else np.zeros(0)
    readings = {'cand_gap_every_anchor': float(every.max(initial=0.0)),
                'cand_gap_p99': float(np.percentile(gaps, 99))
                if len(gaps) else 0.0,
                'served_a_frame': served_prog / n,
                'reference_served_a_frame': served_ref / n,
                'confident_a_frame': sure_prog / n,
                'reference_confident_a_frame': sure_ref / n}
    return {name: {'value': values[name], 'limit': limit}
            for name, limit in cfg['limits'].items()}, readings


def passed(numbers):
    return all(n['value'] <= n['limit'] for n in numbers.values())

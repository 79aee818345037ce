# Copy of watsor_tpu/zones.py: imports adapted.
"""Zones CLI: inspect a camera mask — list detection zones and write an
annotated copy with zone indices.

Operator tooling parity with the reference's zones tool
(upstream watsor, zones.py:42-58, which shows the mask in a cv2
window), re-worked for headless hosts: it prints the zone table and writes
a numbered overlay image; ``--show`` additionally opens the reference's
interactive window when a display is available (falls back to the file
output with a warning when not).

    python -m watsor_tpu_torch.zones -m mask.png [-o annotated.png] [--show]
"""

import argparse

import cv2
import numpy as np

from watsor_tpu_torch.filters.mask import ZoneMask, get_alpha_channel


def annotate(mask_path, out_path=None):
    image = cv2.imread(mask_path, cv2.IMREAD_UNCHANGED)
    alpha = get_alpha_channel(image)
    zone_mask = ZoneMask(alpha, alpha.shape + (3,))

    canvas = image[:, :, :3].copy()
    canvas[alpha == 0] = canvas[alpha == 0] // 2  # dim the masked-out area
    rows = []
    for z in range(1, zone_mask.num_zones + 1):
        ys, xs = np.nonzero(zone_mask.index_map == z)
        cy, cx = int(ys.mean()), int(xs.mean())
        rows.append((z, len(ys), (cx, cy)))
        cv2.putText(canvas, str(z), (cx, cy), cv2.FONT_HERSHEY_SIMPLEX,
                    2.0, (0, 255, 255), 3, cv2.LINE_AA)
        contours, _ = cv2.findContours(
            (zone_mask.index_map == z).astype(np.uint8),
            cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(canvas, contours, -1, (0, 255, 255), 2)
    if out_path:
        cv2.imwrite(out_path, canvas)
    return rows, canvas


def main(argv=None):
    parser = argparse.ArgumentParser(description='Show detection zones of '
                                                 'a camera mask')
    parser.add_argument('-m', '--mask', required=True, help='mask PNG file')
    parser.add_argument('-o', '--output', help='write annotated image here')
    parser.add_argument('--show', action='store_true',
                        help='open the annotated mask in a window (needs '
                             'a display; the reference tool\'s behavior)')
    args = parser.parse_args(argv)
    rows, canvas = annotate(args.mask, args.output)
    if not rows:
        print('No zones found (alpha channel fully transparent?)')
    for z, area, (cx, cy) in rows:
        print('zone {:2d}: {:8d} px, centroid ({}, {})'.format(
            z, area, cx, cy))
    if args.output:
        print('Annotated image written to', args.output)
    if args.show:
        if show_window(canvas):
            return
        print('No display available for --show; use -o to write the '
              'annotated image instead')


def show_window(canvas, title='watsor zones'):
    """The reference's interactive display (zones.py:42-58): show the
    annotated mask until a key is pressed. Returns False on headless
    hosts (no display / GUI-less OpenCV build) instead of raising."""
    import os
    if not os.environ.get('DISPLAY') and not os.environ.get(
            'WAYLAND_DISPLAY'):
        return False
    try:
        cv2.imshow(title, canvas)
        cv2.waitKey(0)
        cv2.destroyAllWindows()
        return True
    except cv2.error:
        return False


if __name__ == '__main__':
    main()

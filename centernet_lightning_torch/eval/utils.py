"""The MOT-Challenge results writer of `inference_tracking` (port of
eval/utils.py:write_mot_results; the COCO converters are not ported yet)."""
from __future__ import annotations

from typing import Sequence

__all__ = ["write_mot_results"]


def write_mot_results(
    path: str, frame_bboxes: Sequence, frame_track_ids: Sequence,
    img_width: float = 1.0, img_height: float = 1.0, start_frame: int = 0,
):
    """Append tracking output in MOT-Challenge format (1-based frame and
    track ids, x, y, w, h in pixels), one line per box."""
    with open(path, "a") as f:
        for offset, (bboxes, ids) in enumerate(zip(frame_bboxes, frame_track_ids)):
            for box, tid in zip(bboxes, ids):
                x1 = box[0] * img_width
                y1 = box[1] * img_height
                x2 = box[2] * img_width
                y2 = box[3] * img_height
                f.write(
                    f"{start_frame + offset + 1},{int(tid) + 1},"
                    f"{x1 + 1},{y1 + 1},{x2 - x1},{y2 - y1},-1,-1,-1,-1\n"
                )

"""ORB feature matching (`tripled_tpu/data/feature_match.py`, the
reference's `mono/datasets/utils.py:125-140`). No training or eval path
uses it. Needs the optional cv2."""

from __future__ import annotations


def extract_match(query_image, train_image, num: int):
    """The `num` best ORB matches by Hamming distance (cross-checked):
    (query points, train points), lists of (x, y) pixel positions."""
    import cv2

    orb = cv2.ORB_create()
    kp_q, des_q = orb.detectAndCompute(query_image, None)
    kp_t, des_t = orb.detectAndCompute(train_image, None)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    matches = sorted(bf.match(des_q, des_t), key=lambda m: m.distance)
    qs, ts = [], []
    for m in matches[:num]:
        qs.append(kp_q[m.queryIdx].pt)
        ts.append(kp_t[m.trainIdx].pt)
    return qs, ts

"""Geometric verification + multi-view geometry.

Replaces reference C12 (cv::findHomography(RANSAC) +
perspectiveTransform, src/main.cpp:44-68) with our own batched
batched-hypothesis RANSAC, and extends it (north star) with two-view
epipolar geometry, triangulation and pose estimation for SfM.
"""

from sift_tpu.geometry.homography import (
    find_homography_ransac, perspective_transform, HomographyResult)

__all__ = ["find_homography_ransac", "perspective_transform",
           "HomographyResult"]

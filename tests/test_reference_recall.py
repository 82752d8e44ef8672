"""The BASELINE.json acceptance gate, measured on its own terms:
>=0.95 keypoint/match recall vs the COMPILED reference binary's
keypoints and ratio-tested matches (golden dumps from
tools/ref_dump, reference demo semantics src/main.cpp:19-54).

Only config 1 (scene.jpg/book.jpg at 960x960) runs here to bound CI
time; `python -m sift_tpu.eval --gate` measures all five pairs.
"""

import os

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "ref_dump.npz")
DATA = "/root/reference/data"


@pytest.mark.skipif(not (os.path.exists(GOLDEN)
                         and os.path.isdir(DATA)),
                    reason="golden reference dump or corpus absent")
@pytest.mark.slow
def test_config1_recall_vs_compiled_reference():
    from sift_tpu.eval import eval_reference_recall
    (r,) = eval_reference_recall(DATA, pairs=["book"])
    assert r["keypoint_recall_scene"] >= 0.95, r
    assert r["keypoint_recall_object"] >= 0.95, r
    assert r["match_recall"] >= 0.95, r
    # keypoint counts land exactly on the reference's (486/128)
    assert abs(r["scene_kpts"] - r["ref_scene_kpts"]) <= 5, r
    assert abs(r["object_kpts"] - r["ref_object_kpts"]) <= 5, r

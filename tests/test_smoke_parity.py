"""Parity and four-device smoke phases at tiny sizes on the CPU (the
virtual 8-device mesh stands in for four cards)."""

from sift_tpu import smoke


def test_phase_parity_tiny():
    out = smoke.phase_parity(scene_hw=(200, 240), obj_hw=(96, 128),
                             oracle_hw=(96, 128))
    assert out["ratio_agree_frac"] >= smoke.RATIO_AGREE_MIN
    assert out["oracle"]["recall"] >= smoke.ORACLE_RECALL_MIN


def test_phase_four_cards_virtual_devices():
    out = smoke.phase_four_cards(4, frame_hw=(512, 320), n_query=256,
                                 n_train=512, n_cams=6, n_pts=400)
    assert out["tiled_detect"]["paired_frac"] >= smoke.KP_PAIRED_MIN

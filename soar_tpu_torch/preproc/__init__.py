"""Preprocessing of a capture (port of ``soar_tpu.preproc``): frames,
keypoints and person masks, the SMPL-X fit and the normal maps."""

"""Depth evaluation: the KITTI Eigen protocol and the evaluator."""

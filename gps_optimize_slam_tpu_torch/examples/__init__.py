"""Runnable examples of the port: ``python -m gps_optimize_slam_tpu_torch.examples.<name>``
(``fuse_kitti04``, ``batch_mesh_fusion``, ``out_of_core_1m``, ``distributed_launch``),
each on the card unless given ``--device cpu``."""

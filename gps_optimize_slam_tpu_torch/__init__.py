"""PyTorch + CUDA port of ``gps_optimize_slam_tpu``: GNSS + SLAM trajectory
fusion (Sim(3) alignment + EKF/RTS) on an NVIDIA Hopper card.

The package never imports JAX. Its module names mirror the JAX package, so
``gps_optimize_slam_tpu.ops.ransac`` is ported in
``gps_optimize_slam_tpu_torch.ops.ransac``. Every Pallas kernel of the JAX
package has a hand-written CUDA C++ counterpart under ``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``). Entry points run on the card
unless the caller passes ``device="cpu"``.

Float32 products stay full float32: TF32 is turned off here, as
``gps_optimize_slam_tpu.utils.precision.highp`` forces full-precision
products in the JAX package (reduced-precision products cost ~0.4 m).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

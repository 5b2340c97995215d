import sys

from gps_optimize_slam_tpu_torch.cli import main

sys.exit(main())

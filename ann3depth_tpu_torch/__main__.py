import sys

from ann3depth_tpu_torch.cli import main

sys.exit(main())

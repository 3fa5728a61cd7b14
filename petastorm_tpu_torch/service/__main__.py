import sys

from petastorm_tpu_torch.service.cli import main

sys.exit(main())

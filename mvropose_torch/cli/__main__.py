import sys

from mvropose_torch.cli.main import main

sys.exit(main())

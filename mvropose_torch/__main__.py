"""`python -m mvropose_torch ...`: the port's command line, as `python -m
mvropose_tpu` is the reference's (`cli/main.py`)."""

import sys

from mvropose_torch.cli.main import main

sys.exit(main())

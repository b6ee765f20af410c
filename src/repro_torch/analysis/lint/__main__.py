import sys

from repro_torch.analysis.lint.cli import main

sys.exit(main())

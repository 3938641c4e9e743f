import sys

from repro_torch.compiler.cli import main

sys.exit(main())

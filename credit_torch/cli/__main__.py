import sys

from credit_torch.cli.main import main

sys.exit(main())

"""credit-torch command line interface."""

from credit_torch.cli.main import main  # noqa: F401

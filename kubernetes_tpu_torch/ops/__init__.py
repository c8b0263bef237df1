"""Ops of the batch pass.  Importing an op module registers its OpDefs."""

from . import common  # noqa: F401
from . import interpodaffinity, noderesources, trivial, unported  # noqa: F401

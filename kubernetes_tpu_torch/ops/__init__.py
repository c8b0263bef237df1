"""Ops of the batch pass.  Importing an op module registers its OpDefs."""

from . import common  # noqa: F401
from . import (  # noqa: F401
    interpodaffinity, nodeaffinity, noderesources, podtopologyspread, tainttoleration, trivial,
    unported, volumes,
)

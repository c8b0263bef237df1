"""Ops of the batch pass.  Importing an op module registers its OpDefs."""

from . import common  # noqa: F401
from . import (  # noqa: F401
    imagelocality, interpodaffinity, nodeaffinity, nodeports, noderesources, podtopologyspread,
    dynamicresources, tainttoleration, trivial, volumes, throughput, learned,
)

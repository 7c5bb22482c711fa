# Host-code copy of eradiate_tpu/test_tools/__init__.py; regenerate with tools/copy_host_code.py, do not edit.
from . import regression  # noqa: F401
from .regression import (  # noqa: F401
    Chi2Test,
    IndependentStudentTTest,
    PairedStudentTTest,
    RegressionTest,
    RMSETest,
    SidakTTest,
    ZTest,
)
